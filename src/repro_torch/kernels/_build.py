"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Every source is compiled by its own ``nvcc``, all started together, and
the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``; the library's name carries a hash of the sources
and flags, so an edited source builds anew and an unchanged one is loaded
from the build directory.  ``-Xptxas -v`` makes each compile report its
kernels' registers, shared memory and spills (kept in ``build_log``).  The build directory is ``build/kernels``
at the root of the checkout (listed in ``.gitignore``), or
``$REPRO_TORCH_BUILD_DIR``.

Only the CUDA path imports this module, so the CPU tests never look for
``nvcc``.  ``-fmad=false`` keeps every product out of a fused multiply-add,
so the kernels round where the reference does (the hit sets and the MBR
prune slack rely on it); division and square root stay IEEE (no
``--use_fast_math``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C signatures of the launch functions (all return cudaError_t as int).
SIGNATURES = {
    "distthresh_dense_launch": (_P, _I, _P, _L, _I, _F, _P, _P, _P, _P),
    "distthresh_compact_launch": (_P, _I, _P, _L, _I, _F, _I, _I, _I, _I, _I,
                                  _P, _P, _F, _P, _P, _P, _P, _P, _P, _P),
    "distthresh_compact_live_launch": (_P, _I, _P, _L, _I, _F, _I, _I, _I,
                                       _I, _I, _P, _P, _P, _I, _P, _P, _P,
                                       _P, _P, _P),
}
# The row-loop kernels take their chunk twins' arguments.
SIGNATURES["distthresh_compact_rowloop_launch"] = SIGNATURES[
    "distthresh_compact_launch"]
SIGNATURES["distthresh_compact_live_rowloop_launch"] = SIGNATURES[
    "distthresh_compact_live_launch"]
SIGNATURES["flashattn_launch"] = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                  _P)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds spent in nvcc by this process (0 when loaded from the cache).
build_seconds = 0.0
#: What the compiles printed (``-Xptxas -v``), per source; empty when the
#: library was loaded from the cache.
build_log: dict[str, str] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libkernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: dict[str, list[str]]) -> dict[str, str]:
    """Run the commands at once; their output by name.  Raises on the
    first that fails, after every one has ended."""
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    out = {name: p.communicate()[0] for name, p in procs.items()}
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmds[name])}\n{out[name]}")
    return out


def build() -> pathlib.Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = {src.name: os.path.join(tmp, src.stem + ".o")
                for src in _sources()}
        build_log.update(_run_all({
            src.name: [nvcc(), *NVCC_FLAGS, "-c", str(src), "-o",
                       objs[src.name]] for src in _sources()}))
        lib = os.path.join(tmp, out.name)
        _run_all({"link": [nvcc(), "-shared", "-o", lib, *objs.values()]})
        os.replace(lib, out)
    build_seconds += time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


__all__ = ["NVCC_FLAGS", "build", "build_dir", "build_log",
           "library_path", "load"]
