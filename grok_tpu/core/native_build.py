"""Content-keyed builds of the native shared libraries (native/*.cpp).

A library is built on the machine that loads it and stored under
``native/build/<key>/``, where the key hashes the sources and headers, the
compiler command and the host CPU. A library built from other sources,
with other flags or for another CPU (``-march=native``) therefore never
matches and is never loaded; the matching one is rebuilt instead.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import tempfile

NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
BUILD_DIR = os.path.join(NATIVE_DIR, "build")


def host_cpu_id() -> str:
    """Model name and feature flags of this host's CPU."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    ident.append(line.strip())
                elif not line.strip() and len(ident) > 1:
                    break  # first processor only
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident)


def build_key(files, cmd) -> str:
    """Hash of the file contents, the command and the host CPU."""
    h = hashlib.sha256()
    for path in sorted(files):
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(cmd).encode())
    h.update(host_cpu_id().encode())
    return h.hexdigest()[:20]


def keyed_path(name: str, files, cmd, build_dir: str = BUILD_DIR) -> str:
    return os.path.join(build_dir, build_key(files, cmd), name)


def build(name: str, files, cmd, compile_to, build_dir: str = BUILD_DIR):
    """Return the keyed library path, building it first if it is absent.

    ``compile_to(tmp_path) -> bool`` writes the library to ``tmp_path``;
    the result is moved into place atomically, so concurrent builds
    never load a half-written file. Returns None when the build fails."""
    out = keyed_path(name, files, cmd, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=os.path.dirname(out))
    try:
        tmp = os.path.join(tmpdir, name)
        if not compile_to(tmp):
            return None
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out
