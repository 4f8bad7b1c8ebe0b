"""ctypes bindings for the native preprocessing fast path.

The shared library is compiled on first use (g++ -O3, cached next to the
source); if no toolchain is available the caller falls back to the pure-
Python implementation in ``poi_tpu_torch/data/dataset.py`` (which doubles as the
property-test oracle — tests/test_torch_standalone.py asserts equal outputs).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "preprocess.cc")
_LIB = os.path.join(_HERE, "libpoipreprocess.so")
_lock = threading.Lock()
_lib = None
_tried = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)


def _build() -> str | None:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native preprocess unavailable (%s); using Python fallback", e)
        return None


def load():
    """Returns the loaded CDLL or None (no toolchain)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.count_train_windows.restype = ctypes.c_int64
        lib.count_train_windows.argtypes = [_I64, _I64, ctypes.c_int64, _U8, ctypes.c_int64]
        lib.build_train_windows.restype = ctypes.c_int64
        lib.build_train_windows.argtypes = [
            _I64, _I64, ctypes.c_int64, _U8, ctypes.c_int64, ctypes.c_int64, _I32,
            _I32, _I32, _I32, _I32, _I32, _F32, _F32,
            _I32, _I32, _I32, _U8, _I32, _I32, _I32, _I32, _F32, _F32,
        ]
        lib.count_eval_examples.restype = ctypes.c_int64
        lib.count_eval_examples.argtypes = [_I64, _I64, ctypes.c_int64, _U8]
        lib.build_eval_examples.restype = ctypes.c_int64
        lib.build_eval_examples.argtypes = [
            _I64, _I64, ctypes.c_int64, _U8, ctypes.c_int64, _I32,
            _I32, _I32, _I32, _I32, _I32, _F32, _F32,
            _I32, _I32, _I32, _U8, _I32, _I32, _I32, _I32, _F32, _F32, _I32,
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _feature_ptrs(feats: dict):
    return (
        _ptr(feats["poi"], _I32),
        _ptr(feats["time_bucket"], _I32),
        _ptr(feats["geo_bucket"], _I32),
        _ptr(feats["tgap_idx"], _I32),
        _ptr(feats["dist_idx"], _I32),
        _ptr(feats["tgap_frac"], _F32),
        _ptr(feats["dist_frac"], _F32),
    )


def _alloc_outputs(n: int, T: int):
    return dict(
        user=np.zeros(n, np.int32),
        poi_in=np.zeros((n, T), np.int32),
        poi_tgt=np.zeros((n, T), np.int32),
        mask=np.zeros((n, T), np.uint8),
        time_bucket=np.zeros((n, T), np.int32),
        geo_bucket=np.zeros((n, T), np.int32),
        tgap_idx=np.zeros((n, T), np.int32),
        dist_idx=np.zeros((n, T), np.int32),
        tgap_frac=np.zeros((n, T), np.float32),
        dist_frac=np.zeros((n, T), np.float32),
    )


def _out_ptrs(o: dict):
    return (
        _ptr(o["user"], _I32), _ptr(o["poi_in"], _I32), _ptr(o["poi_tgt"], _I32),
        _ptr(o["mask"], _U8), _ptr(o["time_bucket"], _I32), _ptr(o["geo_bucket"], _I32),
        _ptr(o["tgap_idx"], _I32), _ptr(o["dist_idx"], _I32),
        _ptr(o["tgap_frac"], _F32), _ptr(o["dist_frac"], _F32),
    )


def build_train_windows(starts, lengths, user_ids, keep, feats, T):
    """Native counterpart of dataset._window_examples. Returns dict of arrays
    (mask as uint8) or None if the native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    keep = np.ascontiguousarray(keep, np.uint8)
    user_ids = np.ascontiguousarray(user_ids, np.int32)
    feats = {k: np.ascontiguousarray(v) for k, v in feats.items()}
    n_users = len(starts)
    n = lib.count_train_windows(_ptr(starts, _I64), _ptr(lengths, _I64), n_users, _ptr(keep, _U8), T)
    out = _alloc_outputs(int(n), T)
    max_len = int(lengths.max()) if n_users else 1
    rows = lib.build_train_windows(
        _ptr(starts, _I64), _ptr(lengths, _I64), n_users, _ptr(keep, _U8),
        T, max_len, _ptr(user_ids, _I32), *_feature_ptrs(feats), *_out_ptrs(out),
    )
    assert rows == n, (rows, n)
    out["target"] = np.zeros(int(n), np.int32)
    return out


def build_eval_examples(starts, lengths, user_ids, is_test, feats, T):
    lib = load()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    is_test = np.ascontiguousarray(is_test, np.uint8)
    user_ids = np.ascontiguousarray(user_ids, np.int32)
    feats = {k: np.ascontiguousarray(v) for k, v in feats.items()}
    n_users = len(starts)
    n = lib.count_eval_examples(_ptr(starts, _I64), _ptr(lengths, _I64), n_users, _ptr(is_test, _U8))
    out = _alloc_outputs(int(n), T)
    target = np.zeros(int(n), np.int32)
    rows = lib.build_eval_examples(
        _ptr(starts, _I64), _ptr(lengths, _I64), n_users, _ptr(is_test, _U8),
        T, _ptr(user_ids, _I32), *_feature_ptrs(feats), *_out_ptrs(out), _ptr(target, _I32),
    )
    assert rows == n, (rows, n)
    out["target"] = target
    return out
