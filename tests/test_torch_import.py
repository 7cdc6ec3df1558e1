"""putslam_tpu_torch imports no JAX and nothing of the JAX package: the
machine with the card has neither."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(code, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['putslam_tpu'] = None\n"
            "import putslam_tpu_torch.run, putslam_tpu_torch.models.slam\n"
            "import putslam_tpu_torch.convert, putslam_tpu_torch.ops.fast_cuda\n"
            "import putslam_tpu_torch.io.synthetic\n"
            "import putslam_tpu_torch.loopclosure.verify\n"
            "import putslam_tpu_torch.motion.ekf, putslam_tpu_torch.ops.klt\n"
            "import putslam_tpu_torch.config\n"
            "import putslam_tpu_torch.io.png, putslam_tpu_torch.io.tum\n"
            "import putslam_tpu_torch.io.native_loader\n"
            "import putslam_tpu_torch.io.xml_config, putslam_tpu_torch.io.icl\n"
            "import putslam_tpu_torch.io.g2o, putslam_tpu_torch.io.rgbdslam\n"
            "import putslam_tpu_torch.utils.checkpoint\n"
            "import putslam_tpu_torch.slam_map.archive\n"
            "import putslam_tpu_torch.eval.ate\n"
            "import putslam_tpu_torch.parallel.multihost\n"
            "import putslam_tpu_torch.parallel.mesh\n"
            "import putslam_tpu_torch.parallel.dist_ba\n"
            "import putslam_tpu_torch.parallel.multi_session\n"
            "import putslam_tpu_torch.geometry.se2\n"
            "import putslam_tpu_torch.io.synthetic2\n"
            "import putslam_tpu_torch.utils.viz\n"
            "import putslam_tpu_torch.models.compiled\n"
            "import putslam_tpu_torch.utils.control\n"
            "import putslam_tpu_torch.utils.graph_cond\n"
            "import putslam_tpu_torch.ops.segment\n"
            "import bench_torch\n"
            "sys.path.insert(0, 'tools')\n"
            "import make_disk_dataset_torch, profile_torch_slam\n"
            "import lc_spread_torch, multihost_dryrun_torch\n"
            "import measure_scaling_torch, profile_vo_torch\n"
            "import run_experiments_torch, export_reference_dataset_torch\n"
            "import run_acceptance_torch, repro_cells_torch\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in\n"
            "            ('jax', 'putslam_tpu') and sys.modules[m] is not None]\n"
            "print('ok')")
    out = _run(code, ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_viz_imports_without_matplotlib():
    """utils/viz.py imports matplotlib only when it draws: with matplotlib
    blocked the module (and run.py) imports, and a plot raises
    ImportError, as the JAX package's would."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "sys.modules['jax'] = None\n"
            "import putslam_tpu_torch.utils.viz as viz, putslam_tpu_torch.run\n"
            "try:\n"
            "    viz.plot_trajectory('x.png', [[0.0] * 7])\n"
            "except ImportError:\n"
            "    print('ok')\n")
    out = _run(code, ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _port_sources():
    """Every source file of the port: the package, the smoke and its tools.
    The modules this walk must reach are named, so a move cannot drop one
    from the check unseen."""
    files = sorted((ROOT / "putslam_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "tools" / "make_disk_dataset_torch.py",
              ROOT / "tools" / "profile_torch_slam.py",
              ROOT / "tools" / "lc_spread_torch.py",
              ROOT / "tools" / "multihost_dryrun_torch.py",
              ROOT / "tools" / "measure_scaling_torch.py",
              ROOT / "tools" / "profile_vo_torch.py",
              ROOT / "tools" / "run_experiments_torch.py",
              ROOT / "tools" / "export_reference_dataset_torch.py",
              ROOT / "tools" / "run_acceptance_torch.py",
              ROOT / "tools" / "repro_cells_torch.py",
              ROOT / "bench_torch.py"]
    rel = {str(f.relative_to(ROOT)) for f in files}
    for name in ("io/png.py", "io/tum.py", "io/native_loader.py",
                 "io/xml_config.py", "io/icl.py", "io/g2o.py",
                 "io/rgbdslam.py", "io/synthetic.py", "slam_map/archive.py",
                 "utils/checkpoint.py", "eval/ate.py", "run.py",
                 "parallel/multihost.py", "parallel/mesh.py",
                 "parallel/dist_ba.py", "parallel/multi_session.py",
                 "geometry/se2.py", "io/synthetic2.py", "utils/viz.py",
                 "ops/klt.py", "models/compiled.py", "utils/control.py",
                 "utils/graph_cond.py", "models/slam.py", "ops/segment.py"):
        assert f"putslam_tpu_torch/{name}" in rel, name
    assert all(f.exists() for f in files)
    return files


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M)
    files = _port_sources()
    assert len(files) > 30
    assert [str(f) for f in files if pat.search(f.read_text())] == []


def test_port_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+putslam_tpu(\.|\s|$)", re.M)
    assert pat.search("import putslam_tpu\n")
    assert pat.search("  from putslam_tpu.config import SlamConfig\n")
    assert not pat.search("from putslam_tpu_torch.config import SlamConfig\n")
    files = _port_sources()
    assert [str(f) for f in files if pat.search(f.read_text())] == []


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA here: the smoke exits non-zero and prints no result, both
    in the repository and alone in an empty directory."""
    script = (ROOT / "chip_smoke.py").read_text()
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script)
    for cwd, path in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(path)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
