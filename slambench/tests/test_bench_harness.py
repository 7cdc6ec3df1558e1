"""The harness on the CPU at the tiny size: files found by name, the
result line, inputs from the seed, what the harness and the reference
import, and the roofline arithmetic."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from slambench import run, spec
from slambench.tests import tiny

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def test_files_found_by_name(root):
    here = root / "slambench"
    assert "fr1_desk" in spec.names("configs", ".json", here)
    assert "tiny" in spec.names("configs", ".json", here)
    assert {"tiny_offline", "tiny_live"} <= set(
        spec.names("traffic", ".json", here))
    assert "fast_score_nms_roofline" in spec.names("metrics", ".py", here)
    # a metric added as a new file is listed and loaded by its name
    (here / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    assert "dummy.count" in spec.names("metrics", ".py", here)
    assert spec.load_module("metrics", "dummy.count", here).read({}) == 7.0
    c = tiny.cell(root, "tiny.offline")
    assert c.config["name"] == "tiny" and c.traffic["mode"] == "offline"
    assert {m["name"] for m in c.end_to_end} == {
        "frames_per_s", "setup_s"}


def test_every_cell_resolves():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = spec.load_cell(w["name"])
        cfg = spec.slam_config(c.config.get("slam", {}))
        assert cfg.camera.width == 640 and cfg.camera.height == 480
        for m in c.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("name,trace", [("tiny.offline", 0),
                                        ("tiny.offline", 1),
                                        ("tiny.live", 0),
                                        ("tiny.live", 1)])
def test_result_line(root, name, trace):
    c = tiny.cell(root, name)
    line = run.run_cell(c, SEED, 0.5, bool(trace), device="cpu",
                        here=root / "slambench")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    assert line["attempted"] > 0
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    json.dumps(line)


def test_same_seed_same_frames(root):
    c = tiny.cell(root, "tiny.offline")
    cpu = torch.device("cpu")
    a = run.Setup(c, SEED, cpu, pin=False)
    b = run.Setup(c, SEED, cpu, pin=False)
    other = run.Setup(c, SEED + 1, cpu, pin=False)
    for (ga, da, ta), (gb, db, tb), (go, do, to) in zip(a.pool, b.pool,
                                                          other.pool):
        assert torch.equal(ga, gb) and torch.equal(da.view(torch.int16),
                                                   db.view(torch.int16))
        assert (ta == tb).all()
        assert not torch.equal(ga, go)
    assert a.ransac_seed(3) == b.ransac_seed(3) != other.ransac_seed(3)


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"],
                         capture_output=True, text=True, cwd=spec.ROOT,
                         check=True, timeout=600)
    return set(out.stdout.split())


def test_harness_loads_no_jax(root):
    mods = _modules_after(
        f"import sys; sys.path.insert(0, {str(spec.ROOT)!r})\n"
        "from slambench import run\n"
        "from slambench.tests import tiny\n"
        f"c = tiny.cell(__import__('pathlib').Path({str(root)!r}), "
        "'tiny.offline')\n"
        f"run.run_cell(c, 5, 0.2, True, device='cpu', here=c and "
        f"__import__('pathlib').Path({str(root)!r}) / 'slambench')")
    assert "putslam_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after(
        f"import sys; sys.path.insert(0, {str(spec.ROOT)!r})\n"
        "from slambench.reference import frontend, poses\n"
        "from slambench import check, gen\n"
        "from slambench.gen import ate, render, walks")
    assert not mods & {"putslam_tpu", "putslam_tpu_torch", "jax", "jaxlib"}


def test_fast_score_nms_bytes_at_fr1():
    cfg = spec.slam_config({})
    roof = spec.load_module("roofline", "fast_score_nms")
    ops, nbytes = roof.counts(cfg)
    assert nbytes == 6_911_844
    assert roof.pyramid_pixels(cfg) == 575_987


def test_ransac_score_counts_at_fr1():
    cfg = spec.slam_config({})
    ops, nbytes = spec.load_module("roofline", "ransac_score").counts(cfg)
    assert ops == 24_493_056 and nbytes == 602_624
