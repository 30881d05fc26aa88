"""Content-keyed native library builds (grok_tpu/core/native_build.py) and
the persistent compile-cache placement (grok_tpu/core/compile_cache.py)."""

import ctypes
import os
import shutil
import subprocess
import sys

import pytest

from grok_tpu.core import compile_cache, native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_lib(tmp_path, value):
    src = tmp_path / "tiny.c"
    src.write_text(f"int tiny(void) {{ return {value}; }}\n")
    cmd = ["gcc", "-shared", "-fPIC"]
    calls = []

    def compile_to(out):
        calls.append(out)
        return subprocess.run(cmd + ["-o", out, str(src)]).returncode == 0

    return [str(src)], cmd, compile_to, calls


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_mismatched_key_is_rebuilt_not_loaded(tmp_path, monkeypatch):
    bdir = str(tmp_path / "build")
    files, cmd, compile_to, calls = _tiny_lib(tmp_path, 1)
    first = native_build.build("libtiny.so", files, cmd, compile_to, bdir)
    assert ctypes.CDLL(first).tiny() == 1
    # same sources, flags and CPU: the keyed library is reused
    assert native_build.build("libtiny.so", files, cmd, compile_to,
                              bdir) == first
    assert len(calls) == 1
    # a library keyed for another CPU is never loaded here
    monkeypatch.setattr(native_build, "host_cpu_id", lambda: "other-cpu")
    other = native_build.build("libtiny.so", files, cmd, compile_to, bdir)
    assert other != first and len(calls) == 2
    monkeypatch.undo()
    # edited sources: a new key, a fresh build that holds the new code
    files, cmd, compile_to, calls = _tiny_lib(tmp_path, 2)
    second = native_build.build("libtiny.so", files, cmd, compile_to, bdir)
    assert second not in (first, other) and len(calls) == 1
    assert ctypes.CDLL(second).tiny() == 2
    # the same key with a failing compiler builds nothing
    files, cmd, _, _ = _tiny_lib(tmp_path, 3)
    assert native_build.build("libtiny.so", files, cmd, lambda out: False,
                              bdir) is None
    assert os.listdir(os.path.dirname(native_build.keyed_path(
        "libtiny.so", files, cmd, bdir))) == []


def test_native_library_path_is_keyed():
    from grok_tpu.t1 import native

    if not native.available():
        pytest.skip("native library unavailable (no compiler)")
    path = native._build()
    assert os.path.dirname(os.path.dirname(path)) == native_build.BUILD_DIR
    assert os.path.basename(path) == "libgrok_tpu_native.so"


@pytest.mark.parametrize("env_dir,jax_first", [
    (False, False), (False, True), (True, False)])
def test_compile_cache_placement(tmp_path, env_dir, jax_first):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    directory inside the checkout, whether or not jax came first."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "JAX_ENABLE_COMPILATION_CACHE")}
    want = compile_cache.DEFAULT_DIR
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    imports = "import jax, grok_tpu" if jax_first else "import grok_tpu, jax"
    r = subprocess.run(
        [sys.executable, "-c",
         f"{imports}; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want
