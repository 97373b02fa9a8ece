"""ctypes bindings of the native data-loading core ``native/tpuloader.cpp``
(a threaded JPEG/PNG decoder and random-crop sampler): counterpart of
``trainner_tpu/data/native_loader.py`` (``available:58``,
``decode_image:62``, ``NativeCropLoader:81``).

The port builds the library itself from the source in the checkout, with
``g++`` and the flags of ``native/Makefile``, into ``build/native/``
(ignored by git) at first use, and never loads a prebuilt
``native/libtpuloader.so``. Where it cannot be built (no compiler, no
libjpeg or libpng headers) ``available()`` is False and the reason is
logged; callers then read images with ``data/common.py``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "tpuloader.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
SO_PATH = os.path.join(BUILD_DIR, "libtpuloader.so")
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

_LIB = None
_ERROR: Optional[str] = None
_LOCK = threading.Lock()
log = logging.getLogger("base")


def build() -> str:
    """Compiles ``native/tpuloader.cpp`` into ``SO_PATH`` (unless a build
    newer than the source is there); returns the path. Raises with the
    compiler's message where it fails."""
    if os.path.exists(SO_PATH) and \
            os.path.getmtime(SO_PATH) >= os.path.getmtime(SOURCE):
        return SO_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, SOURCE,
           *LDLIBS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stderr[-2000:]}")
    os.replace(tmp, SO_PATH)  # atomic: concurrent builds race safely
    return SO_PATH


def _load_lib():
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError) as e:
            _ERROR = str(e)
            log.warning(f"native loader unavailable: {_ERROR}")
            return None
        lib.tl_decode.restype = ctypes.POINTER(ctypes.c_float)
        lib.tl_decode.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.tl_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.tl_create.restype = ctypes.c_void_p
        lib.tl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_uint64]
        lib.tl_next.restype = ctypes.c_int
        lib.tl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
        lib.tl_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def available() -> bool:
    """True once the library is built and loaded."""
    return _load_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load_lib()
    return _ERROR


def decode_image(path: str) -> Optional[np.ndarray]:
    """One JPEG or PNG decoded natively -> float32 RGB HWC in [0, 1]; None
    where the library is unavailable or the file cannot be decoded."""
    lib = _load_lib()
    if lib is None:
        return None
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib.tl_decode(path.encode(), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c))
    if not ptr:
        return None
    n = h.value * w.value * c.value
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.tl_free(ptr)
    return arr.reshape(h.value, w.value, c.value)


class NativeCropLoader:
    """Background-threaded random-crop HR batches: (batch, crop, crop, 3)
    float32 in [0, 1], to pair with the on-device degradations."""

    def __init__(self, paths: List[str], crop: int = 128,
                 batch_size: int = 16, n_threads: int = 4, seed: int = 0):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_ERROR}")
        self._lib = lib
        self.crop = crop
        self.batch_size = batch_size
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._handle = lib.tl_create(arr, len(paths), crop, batch_size,
                                     n_threads, seed)
        if not self._handle:
            raise RuntimeError("tl_create failed")
        self._buf = np.empty(batch_size * crop * crop * 3, np.float32)

    def next(self) -> np.ndarray:
        rc = self._lib.tl_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError("tl_next failed")
        return self._buf.reshape(self.batch_size, self.crop, self.crop,
                                 3).copy()

    def __iter__(self):
        while True:
            yield self.next()

    def close(self) -> None:
        if self._handle:
            self._lib.tl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
