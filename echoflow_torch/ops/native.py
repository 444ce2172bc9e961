"""ctypes binding of the native host normalizer (port of `echoflow.native`).

`zeroone_normalize_native` runs `csrc/preprocess.cc`'s per-channel [0, 1]
normalization on the host: one pass over uint8 decoder output (convert and
normalize fused), or over float32, on up to `threads` threads, one channel
a thread. The library is built at first use with the host C++ compiler
(`ops/_build.build_host`); a failed build raises, and nothing falls back
to numpy. Its output is bitwise the numpy path's
(`ops/normalize.zeroone_normalizer_numpy`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from echoflow_torch.ops import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _library() -> ctypes.CDLL:
    lib = _build.load_host("preprocess")
    if lib.ef_zeroone_u8.argtypes is None:
        for fn, src in ((lib.ef_zeroone_f32, _F32P), (lib.ef_zeroone_u8, _U8P)):
            fn.argtypes = [src, _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            fn.restype = None
    return lib


def zeroone_normalize_native(video: np.ndarray, threads: int | None = None) -> np.ndarray:
    """Per-channel [0, 1] normalization of a (C, ...) video, channel axis
    first, as a new float32 array: uint8 input through the fused kernel,
    any other input converted to float32 first. `threads` defaults to the
    host's cores, at most 4."""
    if threads is None:
        threads = min(4, os.cpu_count() or 1)
    if threads < 1:
        raise ValueError(f"threads must be at least 1, got {threads}")
    lib = _library()
    if video.dtype == np.uint8:
        src, kernel, ptr = np.ascontiguousarray(video), lib.ef_zeroone_u8, _U8P
    else:
        src, kernel, ptr = np.ascontiguousarray(video, np.float32), lib.ef_zeroone_f32, _F32P
    c = src.shape[0]
    out = np.empty(src.shape, np.float32)
    kernel(src.ctypes.data_as(ptr), out.ctypes.data_as(_F32P), c, src.size // c, threads)
    return out
