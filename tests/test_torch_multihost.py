"""The multi-process runtime of the port (parallel/multihost.py) with real
gloo processes on the CPU, through tools/multihost_dryrun_torch.py, as
tests/test_multihost.py drives the JAX package's tool.

Each rank is a separate OS process (the tool imports no JAX: this test
process, whose conftest.py imports JAX, does not fork into them); they meet
at a ``file://`` rendezvous in the test's own directory, so parallel test
workers never race for a port, and every process runs under a time limit
well inside the suite's. The distributed solve must be identical across
the ranks (1e-6 relative), agree with the single-process solve (1e-4
relative on the final chi², tests/test_multihost.py:68-70) and with the JAX
package's solve of the same seeded problem (1e-4)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from putslam_tpu.config import tiny_test_config as jax_tiny
from putslam_tpu.parallel import dist_ba as jdist
from putslam_tpu.parallel import mesh as jmesh
from putslam_tpu_torch.parallel import mesh as tmesh
from putslam_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
SCRIPT = os.path.join(TOOLS, "multihost_dryrun_torch.py")
TIMEOUT_S = 120          # each process; a lost rank fails its collective in 60
sys.path.insert(0, TOOLS)


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _parse(out):
    return json.loads([x for x in out.strip().splitlines()
                       if x.startswith("{")][-1])


def run_ranks(tmp_path, world, extra=()):
    """Start ``world`` ranks of the tool and wait for all: their JSON
    lines. Any rank that fails or outlives the limit fails the test; every
    process is gone when this returns."""
    rdv = tmp_path / f"rdv{world}"
    common = [sys.executable, SCRIPT, "--coordinator", f"file://{rdv}",
              "--num-processes", str(world), "--device", "cpu",
              "--timeout", "60", *extra]
    procs = [subprocess.Popen(common + ["--process-id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env()) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(_parse(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_single(extra=()):
    out = subprocess.run([sys.executable, SCRIPT, "--single", "--device",
                          "cpu", *extra], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    return _parse(out.stdout)


def _jax_chi2_final():
    """The JAX package's tool problem (same seed, same draws) solved by
    the JAX dist_gauss_newton on all 8 virtual devices."""
    import multihost_dryrun as jtool

    kf, kfv, lm, lmv, lmg, g, fixed = jtool.build_problem(
        np.random.default_rng(42))
    _, _, chi2, _ = jdist.dist_gauss_newton(
        jax_tiny().backend, jmesh.make_mesh(8, axis="lm"), kf, kfv, lm, lmv,
        g, fixed, lmg)
    return float(np.asarray(chi2)[-1])


def test_two_process_dist_ba_matches_single_process(tmp_path):
    ref = run_single()
    assert ref["process_count"] == 1 and ref["global_ranks"] == 1
    d0, d1 = run_ranks(tmp_path, 2)
    assert d0["process_count"] == d1["process_count"] == 2
    assert d0["global_ranks"] == 2 and d0["backend"] == "gloo"
    assert (d0["process"], d1["process"]) == (0, 1)
    assert d0["partition_overflow"] == d1["partition_overflow"] == 0
    assert d0["chi2_final"] == pytest.approx(d1["chi2_final"], rel=1e-6)
    assert d0["chi2_final"] == pytest.approx(ref["chi2_final"], rel=1e-4)
    assert ref["chi2_final"] == pytest.approx(_jax_chi2_final(), rel=1e-4)
    assert ref["chi2"][-1] < ref["chi2"][0]


def test_two_processes_on_a_given_problem(tmp_path):
    """--problem carries numpy inputs (here the tool's own problem with a
    pose-pose edge and a stale observation added) and --out brings back
    each rank's poses and landmarks: equal across the ranks, and equal to
    two virtual ranks in one process to float32 summation order."""
    import multihost_dryrun_torch as tool

    from putslam_tpu_torch.backend import graph as graph_mod
    from putslam_tpu_torch.config import tiny_test_config
    from putslam_tpu_torch.geometry import se3

    p = tool.build_problem(np.random.default_rng(3), "cpu")
    g = graph_mod.add_pose_pose(
        p["g"], torch.tensor(1, dtype=torch.int32),
        torch.tensor(2, dtype=torch.int32),
        se3.relative(p["kf_pose"][1], p["kf_pose"][2]), 50.0)
    g = g._replace(obs_gen=g.obs_gen.clone())
    g.obs_gen[5] = 1                          # stale: masked in both
    p["g"] = g
    bcfg = tiny_test_config().backend
    path = tmp_path / "problem.npz"
    tool.save_problem(path, bcfg, None, p["kf_pose"], p["kf_valid"],
                      p["lm_pos"], p["lm_valid"], p["g"], p["fixed_kf"],
                      p["lm_gen"], p["kf_gen"])
    outs = run_ranks(tmp_path, 2, ["--problem", str(path), "--out",
                                   str(tmp_path / "out{rank}.npz")])
    assert outs[0]["chi2"] == outs[1]["chi2"]
    from putslam_tpu_torch.parallel import dist_ba

    kf, lm, chi2, _ = dist_ba.dist_gauss_newton(
        bcfg, tmesh.make_mesh(2, axis="lm", device="cpu"), p["kf_pose"],
        p["kf_valid"], p["lm_pos"], p["lm_valid"], p["g"], p["fixed_kf"],
        p["lm_gen"], p["kf_gen"])
    for r in range(2):
        with np.load(tmp_path / f"out{r}.npz") as f:
            np.testing.assert_allclose(f["kf_pose"], kf.numpy(), atol=1e-6)
            np.testing.assert_allclose(f["lm_pos"], lm.numpy(), atol=1e-6)
    np.testing.assert_allclose(outs[0]["chi2"], chi2.numpy(), rtol=1e-6)


def test_measure_scaling_tool_on_cpu_processes():
    """tools/measure_scaling_torch.py at the dryrun's small capacities over
    1 and 2 gloo processes: a row per world size, labelled as CPU, the
    packed buffer (36K² + 6K + 1 floats) all-reduced once an iteration."""
    out = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "measure_scaling_torch.py"),
         "--device", "cpu", "--caps", "small", "--worlds", "1", "2"],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    res = _parse(out.stdout)
    assert res["platform"] == "cpu-gloo"
    assert [r["world"] for r in res["rows"]] == [1, 2]
    K = res["capacities"]["K"]
    two = res["rows"][1]
    assert two["backend"] == "gloo"
    assert two["all_reduce_bytes_per_iter"] == 4 * (36 * K * K + 6 * K + 1)
    assert all(r["per_gn_iter_ms"] > 0 for r in res["rows"])


@pytest.mark.slow
def test_four_process_dist_ba_matches_single_process(tmp_path):
    ref = run_single()
    outs = run_ranks(tmp_path, 4)
    assert [o["process"] for o in outs] == [0, 1, 2, 3]
    for o in outs:
        assert o["global_ranks"] == 4
        assert o["chi2_final"] == pytest.approx(outs[0]["chi2_final"],
                                                rel=1e-6)
    assert outs[0]["chi2_final"] == pytest.approx(ref["chi2_final"],
                                                  rel=1e-4)


def test_initialize_distributed_without_peers_is_a_no_op():
    """≤ 1 process, or no argument at all, joins nothing (the JAX
    function's contract); half the explicit arguments is an error. The
    mesh then has one rank and the identity reduction."""
    assert multihost.initialize_distributed(num_processes=1) is False
    assert multihost.initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize_distributed("localhost:1", None, 0,
                                         device="cpu")
    assert multihost.process_info() == (0, 1, 1, 1)
    m = multihost.global_mesh(device="cpu")
    assert (m.size, m.axis_names, m.ranks) == (1, ("lm",), (0,))
    assert "identity" in repr(m)
    x = torch.arange(3.0)
    assert m.all_reduce_(x) is x and m.n_all_reduce == 0
    multihost.shutdown()                      # nothing joined: no error


def test_join_group_of_one_runs_its_collective(tmp_path):
    """A group of world size 1 (the card's NCCL case; gloo here) is joined
    and its all-reduce runs and is counted; leaving it restores the
    one-process mesh."""
    import torch.distributed as dist

    backend = multihost.join_group(f"file://{tmp_path / 'rdv'}", 1, 0,
                                   device="cpu")
    try:
        assert backend == "gloo" and dist.get_world_size() == 1
        assert multihost.process_info() == (0, 1, 1, 1)
        m = multihost.global_mesh(device="cpu")
        assert m.group is not None and m.ranks == (0,)
        x = torch.arange(4.0)
        assert torch.equal(m.all_reduce_(x), torch.arange(4.0))
        assert (m.n_all_reduce, m.all_reduce_bytes) == (1, 16)
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()
    assert multihost.global_mesh(device="cpu").group is None


def test_initialize_distributed_autodetect_reads_torchrun_variables(
        monkeypatch):
    """``autodetect=True`` joins through ``env://``: world size and rank
    come from torchrun's variables (a TCP store on localhost)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    try:
        assert multihost.initialize_distributed(autodetect=True,
                                                device="cpu") is True
        assert (dist.get_backend(), dist.get_world_size(),
                dist.get_rank()) == ("gloo", 1, 0)
    finally:
        multihost.shutdown()
