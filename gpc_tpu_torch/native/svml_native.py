"""ctypes binding of the native SVM-light reader (native/svml_reader.cpp),
the counterpart of gpc_tpu/native/svml_native.py."""

from __future__ import annotations

import ctypes

import numpy as np

from gpc_tpu_torch.native.build import load

_DP = ctypes.POINTER(ctypes.c_double)
_LP = ctypes.POINTER(ctypes.c_long)


def _lib():
    lib = load("svml")
    if lib is not None:
        lib.svml_scan.argtypes = [ctypes.c_char_p, _LP, _LP]
        lib.svml_scan.restype = ctypes.c_int
        lib.svml_fill.argtypes = [ctypes.c_char_p, _DP, _DP, ctypes.c_long, ctypes.c_long]
        lib.svml_fill.restype = ctypes.c_long
    return lib


def read(path):
    """(X, y) as io/svml.read_svml gives them, or None when the library
    cannot be built or the file cannot be mapped (an empty file, say): the
    caller then reads it in Python."""
    lib = _lib()
    if lib is None:
        return None
    pathb = str(path).encode()
    n_rows, max_idx = ctypes.c_long(), ctypes.c_long()
    if lib.svml_scan(pathb, ctypes.byref(n_rows), ctypes.byref(max_idx)) != 0:
        return None
    N, D = n_rows.value, max_idx.value
    X = np.zeros((N, D), dtype=np.float64)
    y = np.zeros((N,), dtype=np.float64)
    if lib.svml_fill(pathb, X.ctypes.data_as(_DP), y.ctypes.data_as(_DP), N, D) != N:
        return None
    return X, y.reshape(N, 1)
