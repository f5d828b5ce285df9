"""Tests for the native I/O shim (io/native_io.py + native/io_shim.cpp):
mmap-backed reads and the threaded scan prefetcher, plus the pure-numpy
fallback used when the shared library isn't built."""

import numpy as np
import pytest

from lidar_feature_extraction_tpu.io import native_io


@pytest.fixture()
def scan_files(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    arrays = []
    for i in range(6):
        a = rng.normal(size=(100 + 17 * i) * 4).astype(np.float32)
        p = tmp_path / f"{i:06d}.bin"
        a.tofile(p)
        paths.append(str(p))
        arrays.append(a)
    return paths, arrays


def test_read_f32_native(scan_files):
    paths, arrays = scan_files
    for p, a in zip(paths, arrays):
        np.testing.assert_array_equal(native_io.read_f32(p), a)


def test_read_f32_missing_file(tmp_path):
    with pytest.raises((FileNotFoundError, IOError)):
        native_io.read_f32(str(tmp_path / "nope.bin"))


def test_prefetcher_sequential_and_skip(scan_files):
    paths, arrays = scan_files
    pf = native_io.ScanPrefetcher(paths, n_threads=2, lookahead=3)
    try:
        # In order.
        for i in (0, 1, 2):
            np.testing.assert_array_equal(pf.get(i), arrays[i])
        # Ahead within the submitted window (submission is extended on
        # every get; index 5 is submitted once we ask near it).
        np.testing.assert_array_equal(pf.get(5), arrays[5])
        np.testing.assert_array_equal(pf.get(4), arrays[4])
    finally:
        pf.close()
        pf.close()   # idempotent


def test_numpy_fallback(scan_files, monkeypatch):
    paths, arrays = scan_files
    # Force the fallback branch: pretend the shared library is absent.
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_TRIED", True)
    for p, a in zip(paths, arrays):
        np.testing.assert_array_equal(native_io.read_f32(p), a)
    pf = native_io.ScanPrefetcher(paths, n_threads=2, lookahead=2)
    assert pf._p is None
    for i in range(len(paths)):
        np.testing.assert_array_equal(pf.get(i), arrays[i])
    pf.close()
