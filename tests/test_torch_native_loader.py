"""The port's binding of the native loader (native/libputslam_io.so): single
decode, ordered prefetching stream, decode error, as tests/test_native_loader.py
holds the JAX package's; and native against the port's Python decoder. The
native decoder weighs RGB in its own arithmetic and divides depth by the
scale in float: gray agrees to 2e-3 (half an 8-bit step), depth to 1e-6 m."""

import numpy as np
import pytest

from putslam_tpu.io import native_loader as jnative
from putslam_tpu_torch.io import native_loader as tnative
from putslam_tpu_torch.io import png as tpng
from putslam_tpu_torch.io import tum as ttum


def make_dataset(tmp_path, n=6, w=32, h=24, seed=0):
    rng = np.random.default_rng(seed)
    rgb_paths, depth_paths, grays, depths = [], [], [], []
    for i in range(n):
        rgb = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        d16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        rp = str(tmp_path / f"rgb_{i:05d}.png")
        dp = str(tmp_path / f"depth_{i:05d}.png")
        tpng.write_png(rp, rgb)
        tpng.write_png(dp, d16)
        rgb_paths.append(rp)
        depth_paths.append(dp)
        grays.append((rgb.astype(np.float32) @
                      np.array([0.299, 0.587, 0.114], np.float32)) / 255.0)
        depths.append(d16.astype(np.float32) / 5000.0)
    return rgb_paths, depth_paths, grays, depths


@pytest.fixture(scope="module")
def built():
    if not tnative.available():
        pytest.skip("the native loader's library cannot be built or loaded")
    return True


def test_native_decode_matches_python(tmp_path, built):
    rgb_paths, depth_paths, grays, depths = make_dataset(tmp_path)
    g, d = tnative.decode_pair(rgb_paths[0], depth_paths[0], 32, 24, 5000.0)
    assert g.dtype == d.dtype == np.float32
    np.testing.assert_allclose(g, grays[0], atol=2e-3)
    np.testing.assert_allclose(d, depths[0], atol=1e-6)
    jg, jd = jnative.decode_pair(rgb_paths[0], depth_paths[0], 32, 24, 5000.0)
    assert np.array_equal(g, jg) and np.array_equal(d, jd)   # same library


def test_native_loader_ordered_stream(tmp_path, built):
    rgb_paths, depth_paths, grays, depths = make_dataset(tmp_path, n=10)
    loader = tnative.NativeLoader(rgb_paths, depth_paths, 32, 24,
                                  n_threads=4, queue_cap=3)
    assert len(loader) == 10
    seen = []
    for idx, g, d in loader:
        seen.append(idx)
        np.testing.assert_allclose(g, grays[idx], atol=2e-3)
        np.testing.assert_allclose(d, depths[idx], atol=1e-6)
    assert seen == list(range(10))
    loader.close()
    loader.close()                       # idempotent


def test_native_loader_decode_error(tmp_path, built):
    rgb_paths, depth_paths, _, _ = make_dataset(tmp_path, n=3)
    bad = str(tmp_path / "missing.png")
    loader = tnative.NativeLoader([rgb_paths[0], bad],
                                  [depth_paths[0], depth_paths[1]], 32, 24)
    it = iter(loader)
    idx, g, d = next(it)
    assert idx == 0
    with pytest.raises(IOError):
        next(it)
    loader.close()
    with pytest.raises(IOError):
        tnative.decode_pair(bad, depth_paths[0], 32, 24, 5000.0)
    with pytest.raises(ValueError):
        tnative.NativeLoader(rgb_paths, depth_paths[:1], 32, 24)


def test_dataset_iterates_through_native_and_python_alike(tmp_path, built,
                                                          monkeypatch):
    """TumDataset.__iter__ through the prefetcher and, with the library
    reported absent, through the Python decoder: the same frames to the
    stated rounding, and ``loader`` says which ran."""
    rng = np.random.default_rng(3)
    grays = rng.uniform(0, 1, (5, 24, 32)).astype(np.float32)
    depths = rng.uniform(0.3, 12.0, (5, 24, 32)).astype(np.float32)
    root = str(tmp_path / "seq")
    ttum.write_tum_dataset(root, grays, depths)
    ds = ttum.TumDataset(root)
    nat = list(ds)
    assert ds.loader == "native"
    monkeypatch.setattr(tnative, "available", lambda: False)
    py = list(ds)
    assert ds.loader == "python"
    assert len(nat) == len(py) == 5
    for a, b in zip(nat, py):
        assert a.timestamp == b.timestamp
        np.testing.assert_allclose(a.gray, b.gray, atol=2e-3)
        np.testing.assert_allclose(a.depth, b.depth, atol=1e-6)


def test_library_that_cannot_load_reports_unavailable(tmp_path, monkeypatch):
    """A library file that the loader cannot open gives available() False
    (and a RuntimeError from the entry points), not an OSError."""
    fake = tmp_path / "libputslam_io.so"
    fake.write_bytes(b"this is not a shared object")
    monkeypatch.setattr(tnative, "_SO_PATH", str(fake))
    tnative._load.cache_clear()
    try:
        assert tnative.available() is False
        with pytest.raises(RuntimeError):
            tnative.decode_pair("a", "b", 4, 4, 5000.0)
        with pytest.raises(RuntimeError):
            tnative.NativeLoader(["a"], ["b"], 4, 4)
    finally:
        tnative._load.cache_clear()
