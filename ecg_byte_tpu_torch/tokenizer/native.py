"""ctypes bindings for the native BPE core (``csrc/host/ecgbpe.cpp``).

The port's copy of ``ecg_byte_tpu/tokenizer/native.py``.  The shared
library is built with the host C++ compiler (no ``nvcc``: the CPU tests need
it too) into ``ecg_byte_tpu_torch/build/libecgbpe.so`` at first use, and
again whenever the source is newer than the library.  A failed build
raises: there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "ecgbpe.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libecgbpe.so")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return name
    raise RuntimeError("no C++ compiler (c++ or g++) to build the BPE core")


def _build_library() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    r = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, _SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building the BPE core failed:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, _LIB_PATH)


def load_library() -> ctypes.CDLL:
    """Load the native BPE library, building it first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_SOURCE) > os.path.getmtime(_LIB_PATH)):
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)

        lib.ecgbpe_train.restype = ctypes.c_void_p
        lib.ecgbpe_train.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ecgbpe_train_num_merges.restype = ctypes.c_int32
        lib.ecgbpe_train_num_merges.argtypes = [ctypes.c_void_p]
        lib.ecgbpe_train_ids_len.restype = ctypes.c_int64
        lib.ecgbpe_train_ids_len.argtypes = [ctypes.c_void_p]
        lib.ecgbpe_train_get_ids.restype = None
        lib.ecgbpe_train_get_ids.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ecgbpe_train_seq_total.restype = ctypes.c_int64
        lib.ecgbpe_train_seq_total.argtypes = [ctypes.c_void_p]
        lib.ecgbpe_train_get_merges.restype = None
        lib.ecgbpe_train_get_merges.argtypes = [ctypes.c_void_p] * 4
        lib.ecgbpe_train_free.restype = None
        lib.ecgbpe_train_free.argtypes = [ctypes.c_void_p]

        lib.ecgbpe_encoder_new.restype = ctypes.c_void_p
        lib.ecgbpe_encoder_new.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.ecgbpe_encoder_max_token_len.restype = ctypes.c_int32
        lib.ecgbpe_encoder_max_token_len.argtypes = [ctypes.c_void_p]
        lib.ecgbpe_encode.restype = ctypes.c_int64
        lib.ecgbpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.ecgbpe_encoder_free.restype = None
        lib.ecgbpe_encoder_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def train(corpus: bytes, num_merges: int, verbose: bool = False
          ) -> Tuple[np.ndarray, List[Tuple[List[int], int]]]:
    """Native BPE merge learning.

    Returns ``(ids, merges)``: the merged corpus token ids and the
    reference-format merge list ``[(base_byte_seq, new_id), ...]``.
    """
    lib = load_library()
    handle = lib.ecgbpe_train(corpus, len(corpus), num_merges, int(verbose))
    try:
        n_merges = lib.ecgbpe_train_num_merges(handle)
        ids = np.empty(lib.ecgbpe_train_ids_len(handle), dtype=np.uint32)
        if ids.size:
            lib.ecgbpe_train_get_ids(handle, ids.ctypes.data)
        flat = np.empty(lib.ecgbpe_train_seq_total(handle), dtype=np.uint32)
        offsets = np.zeros(n_merges + 1, dtype=np.int64)
        new_ids = np.empty(n_merges, dtype=np.uint32)
        if n_merges:
            lib.ecgbpe_train_get_merges(
                handle, flat.ctypes.data, offsets.ctypes.data, new_ids.ctypes.data
            )
        merges = [
            (flat[offsets[i]: offsets[i + 1]].tolist(), int(new_ids[i]))
            for i in range(n_merges)
        ]
        return ids, merges
    finally:
        lib.ecgbpe_train_free(handle)


class NativeEncoder:
    """Trie longest-match encoder backed by the C++ core."""

    def __init__(self, merges: Sequence[Tuple[Sequence[int], int]]):
        self._lib = load_library()
        flat = np.asarray([b for seq, _ in merges for b in seq], dtype=np.uint32)
        offsets = np.zeros(len(merges) + 1, dtype=np.int64)
        np.cumsum([len(seq) for seq, _ in merges], out=offsets[1:])
        ids = np.asarray([tid for _, tid in merges], dtype=np.uint32)
        # keep buffers alive for the encoder lifetime
        self._flat, self._offsets, self._ids = flat, offsets, ids
        self._handle = self._lib.ecgbpe_encoder_new(
            flat.ctypes.data if flat.size else None,
            offsets.ctypes.data,
            ids.ctypes.data if ids.size else None,
            len(merges),
        )
        self.max_token_len = self._lib.ecgbpe_encoder_max_token_len(self._handle)

    def encode(self, text: bytes) -> np.ndarray:
        out = np.empty(len(text), dtype=np.uint32)
        n = self._lib.ecgbpe_encode(self._handle, text, len(text), out.ctypes.data)
        return out[:n].copy()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ecgbpe_encoder_free(handle)
            self._handle = None
