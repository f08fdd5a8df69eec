"""Build and load the port's CUDA kernels (K1 to K6 and field_add_sub).

The sources under ``csrc/`` have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` into one shared library under
``build/torch_kernels/`` at the repository root (listed in .gitignore) and
loaded with ``ctypes``: no PyTorch headers, so the build takes seconds.
Each ``.cu`` file compiles to an object in its own ``nvcc`` process, all
started together, and one more call links them.

Nothing here runs when a module is imported: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS: float | None = None  # wall-clock of the last build
PTXAS_LOG = ""  # `-Xptxas -v` output of the last build (registers, spills)


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def build() -> str:
    """Compile csrc/*.cu into build/torch_kernels/libzk_<digest>.so."""
    global BUILD_SECONDS, PTXAS_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libzk_{_digest()}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    objs = []
    for src in _sources():
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src)[:-3] + f"_{os.getpid()}.o"
        )
        objs.append(obj)
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append((src, out))
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"{s}:\n{o}" for s, o in failed)
        )
    tmp = so + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, so)
    for o in objs:
        os.remove(o)
    BUILD_SECONDS = time.perf_counter() - t0
    PTXAS_LOG = "\n".join(logs)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            handle.zk_mont_mul.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
            handle.zk_twiddle_mul.argtypes = [vp, vp, vp, i64, i64, i64, vp]
            handle.zk_redc34.argtypes = [vp, vp, i64, vp]
            handle.zk_g1_add.argtypes = [vp] * 9 + [i64, i32, vp]
            handle.zk_g1_bucket_add.argtypes = [vp] * 7 + [i64, i32, i32, i32, vp]
            handle.zk_g1_double.argtypes = [vp] * 6 + [i64, i32, vp]
            handle.zk_butterfly_rows.argtypes = [vp] * 5 + [i64, vp]
            handle.zk_dit_stage.argtypes = [vp, vp, vp, i64, i32, i32, vp]
            handle.zk_field_add_sub.argtypes = [vp, vp, vp, i64] + [i32] * 4 + [vp]
            for fn in (handle.zk_mont_mul, handle.zk_twiddle_mul,
                       handle.zk_redc34, handle.zk_g1_add,
                       handle.zk_g1_bucket_add, handle.zk_g1_double,
                       handle.zk_butterfly_rows, handle.zk_dit_stage,
                       handle.zk_field_add_sub):
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
