"""ctypes bindings of the native RGB-D loader ``native/libputslam_io.so``
(``native/putslam_io.cpp``): a libpng decode worker pool that hands frames
over strictly in order through a bounded queue. The port's counterpart of
``putslam_tpu/io/native_loader.py:28-143``; it binds the same library.

Where the library is absent, cannot be built, or cannot be loaded (for
example no ``libpng16`` on the machine), ``available()`` is False and
``io/tum.py`` decodes with ``io/png.py``. That is a choice between two host
decoders which give the same frames to rounding; callers report which one
ran (``TumDataset.loader``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native"))
_SO_PATH = os.path.join(_NATIVE_DIR, "libputslam_io.so")


def build(force: bool = False) -> bool:
    """Compile the library with the in-tree Makefile (no-op if current).
    Returns success (``putslam_tpu/io/native_loader.py:28``)."""
    src = os.path.join(_NATIVE_DIR, "putslam_io.cpp")
    if not os.path.exists(src):
        return False
    if (not force and os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(src)):
        return True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR],
                       check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """The bound library, or None (``putslam_tpu/io/native_loader.py:44``).
    Unlike the reference, a library that exists but cannot be loaded gives
    None too instead of an ``OSError``."""
    if not os.path.exists(_SO_PATH) and not build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.ps_loader_create.restype = ctypes.c_void_p
    lib.ps_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.ps_loader_next.restype = ctypes.c_int
    lib.ps_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.ps_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.ps_decode_pair.restype = ctypes.c_int
    lib.ps_decode_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def available() -> bool:
    """True where the library is bound
    (``putslam_tpu/io/native_loader.py:73``)."""
    return _load() is not None


def _float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_pair(rgb_path: str, depth_path: str, width: int, height: int,
                depth_scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """One native decode → (gray (H,W) f32 [0,1], depth (H,W) f32 metres)
    (``putslam_tpu/io/native_loader.py:77``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not built")
    gray = np.empty((height, width), np.float32)
    depth = np.empty((height, width), np.float32)
    rc = lib.ps_decode_pair(
        rgb_path.encode(), depth_path.encode(), width, height,
        ctypes.c_float(depth_scale), _float_ptr(gray), _float_ptr(depth))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {rgb_path}")
    return gray, depth


class NativeLoader:
    """Ordered prefetching iterator over (index, gray, depth)
    (``putslam_tpu/io/native_loader.py:95``)."""

    def __init__(self, rgb_paths, depth_paths, width: int, height: int,
                 depth_scale: float = 5000.0, n_threads: int = 4,
                 queue_cap: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader not built")
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("rgb and depth lists differ in length")
        self._lib = lib
        self._n = len(rgb_paths)
        self._w, self._h = width, height
        rgb_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in rgb_paths])
        depth_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in depth_paths])
        self._handle = lib.ps_loader_create(
            rgb_arr, depth_arr, self._n, width, height,
            ctypes.c_float(depth_scale), n_threads, queue_cap)

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        while True:
            gray = np.empty((self._h, self._w), np.float32)
            depth = np.empty((self._h, self._w), np.float32)
            idx = self._lib.ps_loader_next(
                self._handle, _float_ptr(gray), _float_ptr(depth))
            if idx == -1:
                return
            if idx == -2:
                raise IOError("native decode failure mid-stream")
            yield idx, gray, depth

    def close(self) -> None:
        if self._handle:
            self._lib.ps_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
