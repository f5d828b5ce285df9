"""ctypes bindings for the native I/O shim (native/io_shim.cpp), with a
pure-numpy fallback when the shared library isn't built.

The native path provides mmap-backed reads and a threaded prefetcher so
KITTI replay never stalls the device pipeline.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "native", "liblidar_io.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        # Build lazily if the toolchain is available.
        makefile_dir = os.path.dirname(path)
        if os.path.exists(os.path.join(makefile_dir, "Makefile")):
            os.system(f"make -C {makefile_dir} -s 2>/dev/null")
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.tl_file_size.restype = ctypes.c_int64
        lib.tl_file_size.argtypes = [ctypes.c_char_p]
        lib.tl_read_file.restype = ctypes.c_int64
        lib.tl_read_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64]
        lib.tl_prefetcher_create.restype = ctypes.c_void_p
        lib.tl_prefetcher_create.argtypes = [ctypes.c_int]
        lib.tl_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.tl_prefetcher_submit.restype = ctypes.c_int64
        lib.tl_prefetcher_submit.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p]
        lib.tl_prefetcher_wait_size.restype = ctypes.c_int64
        lib.tl_prefetcher_wait_size.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int64]
        lib.tl_prefetcher_take.restype = ctypes.c_int64
        lib.tl_prefetcher_take.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_int64]
        _LIB = lib
    return _LIB


def read_f32(path: str) -> np.ndarray:
    """Read a raw float32 file (KITTI .bin layout)."""
    lib = _load()
    if lib is None:
        return np.fromfile(path, dtype=np.float32)
    size = lib.tl_file_size(path.encode())
    if size < 0:
        raise FileNotFoundError(path)
    out = np.empty(size // 4, dtype=np.float32)
    got = lib.tl_read_file(path.encode(), out.ctypes.data_as(
        ctypes.c_void_p), size)
    if got != size:
        raise IOError(f"short read of {path}: {got} != {size}")
    return out


class ScanPrefetcher:
    """Threaded read-ahead over an ordered list of scan files."""

    def __init__(self, paths: list[str], n_threads: int = 4,
                 lookahead: int = 8):
        self.paths = paths
        self.lookahead = lookahead
        self._lib = _load()
        self._handles: dict[int, int] = {}
        self._next_submit = 0
        if self._lib is not None:
            self._p = self._lib.tl_prefetcher_create(n_threads)
            self._fill(0)
        else:
            self._p = None

    def _fill(self, upto_index: int):
        while (self._next_submit < len(self.paths)
               and self._next_submit <= upto_index + self.lookahead):
            h = self._lib.tl_prefetcher_submit(
                self._p, self.paths[self._next_submit].encode())
            self._handles[self._next_submit] = h
            self._next_submit += 1

    def get(self, index: int) -> np.ndarray:
        """Float32 contents of scan ``index``; triggers read-ahead."""
        if self._p is None:
            return np.fromfile(self.paths[index], dtype=np.float32)
        self._fill(index)
        h = self._handles[index]
        size = self._lib.tl_prefetcher_wait_size(self._p, h)
        if size < 0:
            raise IOError(f"prefetch failed: {self.paths[index]}")
        out = np.empty(size // 4, dtype=np.float32)
        got = self._lib.tl_prefetcher_take(
            self._p, h, out.ctypes.data_as(ctypes.c_void_p), size)
        if got != size:
            raise IOError(f"prefetch take failed: {self.paths[index]}")
        return out

    def close(self):
        if self._p is not None and self._lib is not None:
            self._lib.tl_prefetcher_destroy(self._p)
            self._p = None

    def __del__(self):
        self.close()
