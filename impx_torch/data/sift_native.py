"""ctypes binding for the native C++ SIFT (native/sift).

Builds on demand (g++, ~2s) and caches the shared library next to the source.
API mirrors ExtractSIFT: `extract(img_u8, max_kpts, contrast_th)` ->
(kpts [N,4] (x, y, scale, response), desc [N,128] float32). RootSIFT
normalization is applied by the caller (impx_torch/data/extractors.py).

A copy of impx/data/sift_native.py (numpy and ctypes; the port imports nothing
of impx). The library is the repository's native/sift, outside both packages.
"""
from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess

import numpy as np

_LIB = None
_SRC_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                    "native", "sift")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = osp.join(_SRC_DIR, "libimpx_sift.so")
    if not osp.isfile(so_path):
        subprocess.run(["make", "-C", _SRC_DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(so_path)
    lib.sift_extract.restype = ctypes.c_int
    lib.sift_extract.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    return lib


def extract(img: np.ndarray, max_kpts: int = 2048, contrast_th: float = 0.04):
    """img: [H,W] uint8 grayscale."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    kpts = np.zeros((max_kpts, 4), np.float32)
    desc = np.zeros((max_kpts, 128), np.float32)
    n = lib.sift_extract(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w,
        max_kpts, ctypes.c_float(contrast_th),
        kpts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return kpts[:n], desc[:n]
