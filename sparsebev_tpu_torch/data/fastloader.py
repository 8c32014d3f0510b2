"""ctypes binding for the native C++ loader (``csrc/fastloader.cpp`` at the
repository root, shared with the JAX package): threaded JPEG decode +
resize/crop/flip straight into batch buffers.

The port's own copy of ``sparsebev_tpu/data/fastloader.py``'s binding; the
C++ and its build (``make -C csrc``, which needs libjpeg) are shared, not
repeated here. It finds ``csrc/libfastloader.so`` as the JAX binding does.
Where the library is absent, :func:`available` is false and the pipeline
decodes with PIL, exactly as in the JAX package (both sit on libjpeg, so the
pixels agree). Which decoder the process uses is logged once, when the
library is first looked up, and named by :func:`decoder`.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "csrc", "libfastloader.so")

_LIB = None
_TRIED = False


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        logging.info("JPEG decoder: PIL (%s is not built)", LIB_PATH)
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        logging.info("JPEG decoder: PIL (%s does not load: %s)", LIB_PATH, e)
        return None
    lib.sbtpu_load_batch.restype = ctypes.c_int
    lib.sbtpu_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sbtpu_probe.restype = ctypes.c_int
    lib.sbtpu_probe.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.sbtpu_decode.restype = ctypes.c_int
    lib.sbtpu_decode.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_int, ctypes.c_int]
    logging.info("JPEG decoder: native %s", LIB_PATH)
    _LIB = lib
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def decoder() -> str:
    """``"native"`` (``csrc/libfastloader.so``) or ``"PIL"``: the decoder
    this process's pipelines use."""
    return "native" if available() else "PIL"


def load_batch(paths: Sequence[str],
               resize_wh: Tuple[int, int],
               crop_xywh: Tuple[int, int, int, int],
               flip: bool = False,
               num_threads: int = 8) -> Optional[np.ndarray]:
    """Decode + bicubic-resize to ``resize_wh=(W,H)`` + crop
    ``crop_xywh=(x, y, out_w, out_h)`` + optional hflip; returns
    [N, out_h, out_w, 3] BGR uint8, or None if the native lib is missing
    or any image failed."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(paths)
    cx, cy, ow, oh = crop_xywh
    out = np.empty((n, oh, ow, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.sbtpu_load_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        resize_wh[0], resize_wh[1], cx, cy, ow, oh,
        1 if flip else 0, num_threads)
    if ok != n:
        return None
    return out


def decode(path: str) -> Optional[np.ndarray]:
    """Plain decode to BGR uint8 [H, W, 3] (no resize)."""
    lib = _find_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.sbtpu_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.sbtpu_decode(path.encode(),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        w.value, h.value) != 0:
        return None
    return out
