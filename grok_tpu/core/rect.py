"""Rectangle / canvas-coordinate math for the JPEG 2000 reference grid.

Reimplementation of the geometry helpers the reference keeps in
``src/lib/jp2/util/util.h`` (grkRect<T>, grkPoint) — re-derived from the
ITU-T T.800 Annex B canvas equations, not translated.

All rects are half-open: [x0, x1) x [y0, y1).
"""

from __future__ import annotations

from dataclasses import dataclass


def ceil_div(a: int, b: int) -> int:
    """Ceiling division for non-negative b (a may be any sign)."""
    return -(-a // b)


def floor_div(a: int, b: int) -> int:
    return a // b


def ceil_div_pow2(a: int, n: int) -> int:
    """ceil(a / 2**n) for ints (a may be negative)."""
    return -((-a) >> n)


def floor_div_pow2(a: int, n: int) -> int:
    return a >> n


@dataclass(frozen=True)
class Rect:
    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0

    @property
    def width(self) -> int:
        return max(0, self.x1 - self.x0)

    @property
    def height(self) -> int:
        return max(0, self.y1 - self.y0)

    @property
    def area(self) -> int:
        return self.width * self.height

    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0

    def intersect(self, o: "Rect") -> "Rect":
        return Rect(
            max(self.x0, o.x0),
            max(self.y0, o.y0),
            min(self.x1, o.x1),
            min(self.y1, o.y1),
        )

    def union(self, o: "Rect") -> "Rect":
        if self.empty():
            return o
        if o.empty():
            return self
        return Rect(
            min(self.x0, o.x0),
            min(self.y0, o.y0),
            max(self.x1, o.x1),
            max(self.y1, o.y1),
        )

    def contains(self, o: "Rect") -> bool:
        return (
            self.x0 <= o.x0 and self.y0 <= o.y0 and self.x1 >= o.x1 and self.y1 >= o.y1
        )

    def contains_point(self, x: int, y: int) -> bool:
        return self.x0 <= x < self.x1 and self.y0 <= y < self.y1

    def grow(self, dx: int, dy: int | None = None) -> "Rect":
        if dy is None:
            dy = dx
        return Rect(self.x0 - dx, self.y0 - dy, self.x1 + dx, self.y1 + dy)

    def shift(self, dx: int, dy: int) -> "Rect":
        return Rect(self.x0 + dx, self.y0 + dy, self.x1 + dx, self.y1 + dy)

    def ceil_div_pow2(self, nx: int, ny: int | None = None) -> "Rect":
        """Map a rect down a dyadic level: ceil(coord / 2**n) on every edge.

        This is the T.800 B.5 resolution/component mapping primitive.
        """
        if ny is None:
            ny = nx
        return Rect(
            ceil_div_pow2(self.x0, nx),
            ceil_div_pow2(self.y0, ny),
            ceil_div_pow2(self.x1, nx),
            ceil_div_pow2(self.y1, ny),
        )

    def ceil_div(self, dx: int, dy: int) -> "Rect":
        return Rect(
            ceil_div(self.x0, dx),
            ceil_div(self.y0, dy),
            ceil_div(self.x1, dx),
            ceil_div(self.y1, dy),
        )

    def as_tuple(self) -> tuple[int, int, int, int]:
        return (self.x0, self.y0, self.x1, self.y1)

    def __repr__(self) -> str:  # compact, debug-friendly
        return f"Rect[{self.x0},{self.y0},{self.x1},{self.y1})"
