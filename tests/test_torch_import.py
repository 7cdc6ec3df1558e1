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
            "assert not [m for m in sys.modules if m.split('.')[0] in\n"
            "            ('jax', 'putslam_tpu') and sys.modules[m] is not None]\n"
            "print('ok')")
    out = _run(code, ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M)
    files = sorted((ROOT / "putslam_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert [str(f) for f in files if pat.search(f.read_text())] == []


def test_port_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+putslam_tpu(\.|\s|$)", re.M)
    assert pat.search("import putslam_tpu\n")
    assert pat.search("  from putslam_tpu.config import SlamConfig\n")
    assert not pat.search("from putslam_tpu_torch.config import SlamConfig\n")
    files = sorted((ROOT / "putslam_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
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
