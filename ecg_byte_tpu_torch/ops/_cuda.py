"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``.  The build runs at first use and again
whenever a source is newer than the library, and goes into
``ecg_byte_tpu_torch/build/``.  Including no PyTorch header keeps the build
to seconds.  (``csrc/host/`` holds host C++ that ``nvcc`` never sees.)

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libecg_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry returns the cudaError_t of its launch
_SIGNATURES = {
    # qg, k, v, pad_mask, out, B, S, KH, G, D, stream
    "ecg_prefill_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qg, k, v, pad_mask, out, dout, dq, dk, dv, stats, B, S, KH, G, D, stream
    "ecg_prefill_attention_bwd": [_P] * 10 + [_I, _I, _I, _I, _I, _P],
    # q, k_cache, v_cache, valid_mask, out, B, S, KH, G, D, stream
    "ecg_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # filled by the build: seconds, ptxas report


def _sources():
    return sorted(
        glob.glob(os.path.join(_CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(_CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    units = [s for s in _sources() if s.endswith(".cu")]
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(u)[:-3] + f".{tag}.o") for u in units]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, u],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for u, o in zip(units, objs)
    ]
    reports = [p.communicate()[0] for p in procs]
    try:
        for u, p, rep in zip(units, procs, reports):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(u)}:\n{rep}")
        # link to a private name, then rename: a concurrent process never
        # loads a half-written library
        tmp = f"{_LIB_PATH}.{tag}"
        r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = "".join(reports)


def library() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ecg_error_string.argtypes = [ctypes.c_int]
            lib.ecg_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().ecg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
