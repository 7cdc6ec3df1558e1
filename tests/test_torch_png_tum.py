"""The port's PNG codec and TUM player against the JAX package's (both plain
numpy): files byte for byte, decoded arrays exact, on 8/16-bit gray and RGB
and on each of the five scanline filters; timestamp association, trajectory
files, a written sequence read back by both readers, and the uint8 / uint16
wire format exact."""

import struct
import zlib

import numpy as np
import pytest
import torch
from _torch_port import n

from putslam_tpu.io import png as jpng
from putslam_tpu.io import tum as jtum
from putslam_tpu_torch.config import tum_fr1_config
from putslam_tpu_torch.io import png as tpng
from putslam_tpu_torch.io import tum as ttum
from putslam_tpu_torch.models import slam as tslam


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "gray8": rng.integers(0, 256, (13, 17), dtype=np.uint8),
        "gray16": rng.integers(0, 65536, (11, 9)).astype(np.uint16),
        "rgb8": rng.integers(0, 256, (7, 10, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_write_png_bytes_equal_and_cross_read(tmp_path, kind):
    img = _images()[kind]
    jp, tp = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jpng.write_png(jp, img)
    tpng.write_png(tp, img)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for path in (jp, tp):                      # each reads the other's file
        for reader in (jpng.read_png, tpng.read_png):
            out = reader(path)
            assert out.dtype == img.dtype and np.array_equal(out, img)


def test_write_png_rejects_unsupported(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            tpng.write_png(str(tmp_path / "x.png"), bad)
    (tmp_path / "no.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        tpng.read_png(str(tmp_path / "no.png"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filtered_png(path, img, ft):
    """Write ``img`` with every scanline filtered by ``ft`` (the PNG
    specification's forward filters, byte by byte)."""
    if img.dtype == np.uint16:
        rows = img[:, :, None].astype(">u2").view(np.uint8)
        rows = rows.reshape(img.shape[0], -1)
        depth, color, bpp = 16, 0, 2
    elif img.ndim == 3:
        rows = img.reshape(img.shape[0], -1)
        depth, color, bpp = 8, 2, 3
    else:
        rows, depth, color, bpp = img, 8, 0, 1
    h, stride = rows.shape
    w = img.shape[1]
    out = bytearray()
    prev = [0] * stride
    for y in range(h):
        cur = [int(v) for v in rows[y]]
        out.append(ft)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1,
                    4: _paeth(a, b, c)}[ft]
            out.append((cur[i] - pred) & 0xFF)
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    data = zlib.compress(bytes(out), 6)
    half = len(data) // 2                      # two IDAT chunks
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:])
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_read_png_filters_equal(tmp_path, kind, ft):
    img = _images(seed=ft + 1)[kind]
    path = str(tmp_path / "f.png")
    _filtered_png(path, img, ft)
    ours = tpng.read_png(path)
    ref = jpng.read_png(path)
    assert ours.dtype == ref.dtype == img.dtype
    assert np.array_equal(ours, img) and np.array_equal(ref, img)


def test_read_png_bad_filter_raises(tmp_path):
    path = str(tmp_path / "f.png")
    _filtered_png(path, _images()["gray8"], 0)
    raw = open(path, "rb").read()
    # rebuild with filter type 7 on the first scanline
    img = _images()["gray8"]
    lines = b"".join(b"\x07" + img[y].tobytes() for y in range(img.shape[0]))
    data = zlib.compress(lines)
    ihdr = raw[8:33]
    idat = (struct.pack(">I", len(data)) + b"IDAT" + data
            + struct.pack(">I", zlib.crc32(b"IDAT" + data) & 0xFFFFFFFF))
    open(path, "wb").write(raw[:8] + ihdr + idat)
    with pytest.raises(ValueError):
        tpng.read_png(path)


def _stamps(case, rng):
    a = np.arange(12) / 30.0 + 100.0
    if case == "exact":
        b = a.copy()
    elif case == "jitter":
        b = a + rng.uniform(-0.012, 0.012, a.shape)
    elif case == "missing":
        b = np.delete(a + rng.uniform(-0.005, 0.005, a.shape), [2, 7])
    elif case == "dense":               # two candidates inside the gate
        b = np.sort(np.concatenate([a + 0.004, a[::3] - 0.009]))
    else:                               # "offset": nothing within the gate
        b = a + 0.5
    return ([(float(t), [f"a{i}"]) for i, t in enumerate(a)],
            [(float(t), [f"b{i}"]) for i, t in enumerate(b)])


@pytest.mark.parametrize("case", ["exact", "jitter", "missing", "dense",
                                  "offset"])
def test_associate_equal(case):
    a, b = _stamps(case, np.random.default_rng(5))
    assert ttum.associate(a, b) == jtum.associate(a, b)
    assert ttum.associate(a, b, offset=0.001, max_difference=0.01) == \
        jtum.associate(a, b, offset=0.001, max_difference=0.01)
    if case == "offset":
        assert ttum.associate(a, b) == []
        assert len(ttum.associate(a, b, offset=-0.5)) == len(a)


def test_trajectory_files_equal(tmp_path):
    rng = np.random.default_rng(2)
    ts = 1305031102.0 + np.arange(9) / 30.0
    q = rng.normal(size=(9, 4))
    poses = np.concatenate([rng.normal(size=(9, 3)),
                            q / np.linalg.norm(q, axis=1, keepdims=True)],
                           axis=1).astype(np.float32)
    jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtum.save_trajectory(jp, ts, poses)
    ttum.save_trajectory(tp, ts, poses)
    assert open(jp).read() == open(tp).read()
    for path in (jp, tp):
        jt, jposes = jtum.load_trajectory(path)
        tt, tposes = ttum.load_trajectory(path)
        assert tt.dtype == np.float64 and tposes.dtype == np.float32
        assert np.array_equal(jt, tt) and np.array_equal(jposes, tposes)
    np.testing.assert_allclose(tposes, poses, atol=1e-6)   # file is xyzw
    assert ttum._read_file_list(tp) == jtum._read_file_list(tp)


def _sequence(T=4, H=24, W=32, seed=9):
    rng = np.random.default_rng(seed)
    grays = rng.uniform(0, 1, (T, H, W)).astype(np.float32)
    depths = rng.uniform(0.3, 6.0, (T, H, W)).astype(np.float32)
    depths[:, :2] = 0.0                                    # holes
    depths[:, 2, :4] = 20.0                                # clips at 65535
    q = rng.normal(size=(T, 4))
    gt = np.concatenate([rng.normal(size=(T, 3)),
                         q / np.linalg.norm(q, axis=1, keepdims=True)],
                        axis=1).astype(np.float32)
    return grays, depths, gt


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_write_tum_dataset_equal_and_both_readers_agree(tmp_path):
    grays, depths, gt = _sequence()
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jtum.write_tum_dataset(str(jroot), grays, depths, gt)
    assert ttum.write_tum_dataset(str(troot), grays, depths, gt) == str(troot)
    assert _tree(jroot) == _tree(troot)                    # every file equal
    assert {"rgb.txt", "depth.txt", "groundtruth.txt"} <= set(_tree(troot))

    jds, tds = jtum.TumDataset(str(troot)), ttum.TumDataset(str(jroot))
    assert len(jds) == len(tds) == len(grays)
    assert [p[0] for p in jds.pairs] == [p[0] for p in tds.pairs]
    assert [p[1:] for p in jds.pairs] == [p[1:] for p in tds.pairs]
    assert np.array_equal(jds.groundtruth[0], tds.groundtruth[0])
    assert np.array_equal(jds.groundtruth[1], tds.groundtruth[1])
    assert np.array_equal(jds.starting_pose(), tds.starting_pose())
    for i in range(len(grays)):
        jf, tf = jds[i], tds[i]
        assert jf.timestamp == tf.timestamp
        assert tf.gray.dtype == np.float32 and tf.depth.dtype == np.float32
        assert np.array_equal(jf.gray, tf.gray)
        assert np.array_equal(jf.depth, tf.depth)
        # the PNG quantisation: 1/255 gray, 1/5000 m depth, clip at 65535
        np.testing.assert_allclose(tf.gray, grays[i], atol=0.5 / 255 + 1e-6)
        np.testing.assert_allclose(
            tf.depth, np.minimum(depths[i], 65535 / 5000.0),
            atol=0.5 / 5000 + 1e-6)
    # iteration (native prefetcher where it loads, else Python) against
    # indexing: float gray rounds to 1/255 through the 8-bit file, depth to
    # one count of the scale
    frames = list(tds)
    assert tds.loader in ("native", "python")
    assert [f.timestamp for f in frames] == [p[0] for p in tds.pairs]
    for i, f in enumerate(frames):
        np.testing.assert_allclose(f.gray, tds[i].gray, atol=1 / 255)
        np.testing.assert_allclose(f.depth, tds[i].depth, atol=1 / 5000)


def test_rgb_frames_turn_gray_as_in_the_reference(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    for i in range(2):
        tpng.write_png(str(root / "rgb" / f"{i}.png"),
                       rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
        tpng.write_png(str(root / "depth" / f"{i}.png"),
                       rng.integers(0, 65536, (6, 8)).astype(np.uint16))
    (root / "rgb.txt").write_text("# c\n0.0 rgb/0.png\n0.1 rgb/1.png\n")
    (root / "depth.txt").write_text("0.004 depth/0.png\n0.31 depth/1.png\n")
    jds, tds = jtum.TumDataset(str(root)), ttum.TumDataset(str(root))
    assert len(tds) == len(jds) == 1               # 0.1 / 0.31 do not pair
    assert tds.groundtruth is None and tds.starting_pose() is None
    assert np.array_equal(tds[0].gray, jds[0].gray)
    assert np.array_equal(tds[0].depth, jds[0].depth)


def test_wire_format_round_trip_bit_for_bit(tmp_path):
    """write → read → the uint8 / uint16 arrays the runner keeps on the host
    (run.py) → the device cast: the same integers as the JAX package's
    path, 65535 and counts ≥ 32768 included."""
    import jax.numpy as jnp

    from putslam_tpu.config import tum_fr1_config as jcfg
    from putslam_tpu.models import slam as jslam

    grays, depths, _ = _sequence(T=2, seed=12)
    depths[0, 5, :6] = np.array([32767, 32768, 40000, 65534, 65535, 65535.4],
                                np.float32) / 5000.0
    root = tmp_path / "w"
    ttum.write_tum_dataset(str(root), grays, depths)
    scale = 5000.0

    def wire(ds):
        g8 = np.empty(grays.shape, np.uint8)
        d16 = np.empty(depths.shape, np.uint16)
        for i in range(len(ds)):
            f = ds[i]
            g8[i] = np.clip(f.gray * 255.0 + 0.5, 0, 255)
            d16[i] = np.clip(f.depth * scale + 0.5, 0, 65535)
        return g8, d16

    jg, jd = wire(jtum.TumDataset(str(root)))
    tg, td = wire(ttum.TumDataset(str(root)))
    assert np.array_equal(jg, tg) and np.array_equal(jd, td)
    # the file's own integers come back
    assert np.array_equal(tg[0], tpng.read_png(
        str(root / "rgb" / "0.000000.png")))
    assert np.array_equal(td[0], tpng.read_png(
        str(root / "depth" / "0.000000.png")))
    assert td.max() == 65535 and (td >= 32768).sum() >= 5
    pg, pd = tslam._to_device_float(tum_fr1_config(), tg, td,
                                    torch.device("cpu"))
    rg, rd = jslam._to_device_float(jcfg(), jnp.asarray(jg), jnp.asarray(jd))
    assert pg.dtype == pd.dtype == torch.float32
    assert np.array_equal(n(pg), np.asarray(rg))
    assert np.array_equal(n(pd), np.asarray(rd))
    assert float(pd.max()) == np.float32(65535) / np.float32(5000.0)
    # lists of frames and torch.uint16 tensors take the same route
    pg2, pd2 = tslam._to_device_float(tum_fr1_config(), list(tg), list(td),
                                      torch.device("cpu"))
    assert torch.equal(pg2, pg) and torch.equal(pd2, pd)
    _, pd3 = tslam._to_device_float(tum_fr1_config(), torch.from_numpy(tg),
                                    torch.from_numpy(td), torch.device("cpu"))
    assert torch.equal(pd3, pd)
