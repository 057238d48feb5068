"""Native host-pipeline bindings (ctypes over ``host_pipeline.cpp``; port of
``embodiedscan_tpu/native/__init__.py`` with its own copy of the core).

The C++ core runs the loader's per-view math (depth back-projection, the
ego -> world transform, row sampling, image normalization) compiled,
threaded and without the interpreter lock, so the host keeps the card fed.
It is compiled with ``g++`` at first use into ``_cache/`` beside this file
(keyed by a hash of the source); ``data.pipeline`` has a numpy path for
every entry point, which ``DataConfig.native_pipeline = 'numpy'`` selects
and which ``'auto'`` takes where no compiler is found.

Public surface:
    available() -> bool
    multiview_backproject(depths, cam2imgs, global2egos, depth_scale, cap)
    sample_indices(n, num, seed) / gather_rows3(pts, idx)
    normalize_imgs_u8(imgs, mean, std, bgr_to_rgb)
    depth_u16_to_f32(raw, scale)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'host_pipeline.cpp')
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

# thread count for the C++ pools (0 = hardware_concurrency)
N_THREADS = int(os.environ.get('EMBODIEDSCAN_NATIVE_THREADS', '0'))


def _build() -> str | None:
    """Path of the compiled core (built here if absent), or None when
    ``g++`` is missing or fails. Processes that build it at once each
    write a temporary file of their own; the rename is atomic."""
    with open(_SRC, 'rb') as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(_HERE, '_cache')
    so = os.path.join(cache, f'libeshost-{tag}.so')
    if os.path.exists(so):
        return so
    os.makedirs(cache, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    cmd = ['g++', '-O3', '-std=c++17', '-shared', '-fPIC', '-pthread',
           _SRC, '-o', tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get('EMBODIEDSCAN_NO_NATIVE'):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.es_multiview_backproject.restype = ctypes.c_int
        lib.es_multiview_backproject.argtypes = [
            f32p, f32p, f32p, ctypes.c_float, i64, i64, i64, i64,
            ctypes.c_int, f32p, i64p]
        lib.es_sample_indices.restype = None
        lib.es_sample_indices.argtypes = [i64, i64, ctypes.c_uint64, i64p]
        lib.es_gather_rows3.restype = None
        lib.es_gather_rows3.argtypes = [f32p, i64p, i64, f32p]
        lib.es_normalize_u8.restype = None
        lib.es_normalize_u8.argtypes = [u8p, i64, f32p, f32p, ctypes.c_int,
                                        ctypes.c_int, f32p]
        lib.es_depth_u16_to_f32.restype = None
        lib.es_depth_u16_to_f32.argtypes = [u16p, i64, ctypes.c_float, f32p]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the compiled core loaded (or could be built) here."""
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError('the native host core is unavailable (no g++, '
                           'a failed build or EMBODIEDSCAN_NO_NATIVE)')
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pad44(mats: np.ndarray) -> np.ndarray:
    """(V, r, c) intrinsics/extrinsics -> contiguous (V, 4, 4) float32."""
    v = mats.shape[0]
    out = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    r, c = mats.shape[1], mats.shape[2]
    out[:, :r, :c] = mats
    return np.ascontiguousarray(out)


def multiview_backproject(depths: np.ndarray, cam2imgs: np.ndarray,
                          global2egos: np.ndarray | None,
                          depth_scale: float = 1.0,
                          cap: int | None = None):
    """Fused depth -> (world-frame) points for V views, threaded.

    Equivalent to per-view ``pipeline.rgbd_to_points`` followed by
    ``pipeline.aggregate_points_list`` (ego -> global via the world -> cam
    extrinsic's inverse), with the same row order (v-major raster scan of
    the nonzero depths).

    Returns:
        (pts (V, cap, 3) float32, counts (V,) int64).
    """
    lib = _lib()
    depths = np.ascontiguousarray(depths, np.float32)
    v, h, w = depths.shape
    k44 = _pad44(np.asarray(cam2imgs, np.float32))
    e44 = None
    if global2egos is not None:
        e44 = _pad44(np.asarray(global2egos, np.float32))
    if cap is None:
        cap = h * w
    out = np.empty((v, cap, 3), np.float32)
    counts = np.empty((v,), np.int64)
    rc = lib.es_multiview_backproject(
        _fptr(depths), _fptr(k44),
        _fptr(e44) if e44 is not None else None,
        ctypes.c_float(depth_scale), v, h, w, cap, N_THREADS, _fptr(out),
        _iptr(counts))
    if rc != 0:
        raise ValueError('singular intrinsic/extrinsic matrix')
    return out, counts


def sample_indices(n: int, num: int, seed: int) -> np.ndarray:
    """Deterministic row sampling (without replacement when n >= num)."""
    lib = _lib()
    out = np.empty((num,), np.int64)
    lib.es_sample_indices(n, num, ctypes.c_uint64(seed & (2**64 - 1)),
                          _iptr(out))
    return out


def gather_rows3(pts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(num, 3) rows ``pts[idx]``; every index must lie in [0, len(pts))."""
    lib = _lib()
    pts = np.ascontiguousarray(pts, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f'gather_rows3: pts of shape {pts.shape}')
    if len(idx) and (idx.min() < 0 or idx.max() >= len(pts)):
        raise IndexError('gather_rows3: index out of range')
    out = np.empty((len(idx), 3), np.float32)
    lib.es_gather_rows3(_fptr(pts), _iptr(idx), len(idx), _fptr(out))
    return out


def normalize_imgs_u8(imgs: np.ndarray, mean: np.ndarray, std: np.ndarray,
                      bgr_to_rgb: bool = False) -> np.ndarray:
    """(..., 3) uint8 -> normalized float32 (pipeline.normalize_imgs)."""
    lib = _lib()
    imgs = np.ascontiguousarray(imgs, np.uint8)
    if imgs.shape[-1] != 3:
        raise ValueError(f'normalize_imgs_u8: images of shape {imgs.shape}')
    out = np.empty(imgs.shape, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.es_normalize_u8(
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        imgs.size // 3, _fptr(mean), _fptr(std), int(bgr_to_rgb), N_THREADS,
        _fptr(out))
    return out


def depth_u16_to_f32(raw: np.ndarray, scale: float) -> np.ndarray:
    """uint16 depth image -> float32 meters (divide by the depth shift)."""
    lib = _lib()
    raw = np.ascontiguousarray(raw, np.uint16)
    out = np.empty(raw.shape, np.float32)
    lib.es_depth_u16_to_f32(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        raw.size, ctypes.c_float(scale), _fptr(out))
    return out
