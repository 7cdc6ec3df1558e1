"""The one loader of the port's CUDA libraries (``utils/cuda_lib.py``) on
the CPU.

A library's build is named by a hash of its source, the flags and every
header it includes. Every kernel source counts its launches through
``csrc/launch_counter.cuh`` and has exactly one registered ``Library``;
the plumbing (``graph_cond``, ``stamp``) has no counter. A process that
has loaded no library reads no launch counter. The loader binds, checks
and loads a library (a host-only stand-in built with gcc). The layers stay
in order: no module under ``utils/`` imports ``ops/``, and ``ctypes.CDLL``
loads a ``csrc/`` library in one place. The kernel names the roofline
metrics look for in a trace are kernels of ``csrc/``. The libraries
themselves build and run on the card only (``tests/test_torch_*_cuda.py``).
"""

import ast
import ctypes
import importlib
import os
import pathlib
import pkgutil
import re
import shutil
import subprocess
import sys

import _torch_port  # noqa: F401  (one thread a worker)
import pytest

import putslam_tpu_torch.ops
from putslam_tpu_torch.ops import keypoints
from putslam_tpu_torch.utils import cuda_lib

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "putslam_tpu_torch"
HEADER = cuda_lib.CSRC / "launch_counter.cuh"
PLUMBING = {"graph_cond", "stamp"}       # libraries with no launch counter


def _import_ops():
    for mod in pkgutil.iter_modules(putslam_tpu_torch.ops.__path__):
        importlib.import_module(f"putslam_tpu_torch.ops.{mod.name}")


def test_build_path_covers_the_included_headers(tmp_path):
    """A library's build is named by a hash of its source, the flags and
    every header the source includes (here through a second header): a
    changed header builds anew, an unchanged tree reuses the build."""
    src = tmp_path / "ransac_score.cu"
    shutil.copy(cuda_lib.CSRC / "ransac_score.cu", src)
    for header in ("horn_fit.cuh", "launch_counter.cuh"):
        shutil.copy(cuda_lib.CSRC / header, tmp_path / header)
    flags = cuda_lib.NVCC_FLAGS
    assert cuda_lib.included_sources(src) == [
        src.resolve(), (tmp_path / "horn_fit.cuh").resolve(),
        (tmp_path / "launch_counter.cuh").resolve()]
    first = cuda_lib.compiled_path(src, flags)
    assert cuda_lib.compiled_path(src, flags) == first
    assert first.name.startswith("ransac_score_")
    header = tmp_path / "horn_fit.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    second = cuda_lib.compiled_path(src, flags)
    assert second != first
    # a header included by a header counts too
    (tmp_path / "inner.cuh").write_text("// inner\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    third = cuda_lib.compiled_path(src, flags)
    (tmp_path / "inner.cuh").write_text("// inner, changed\n")
    assert cuda_lib.compiled_path(src, flags) not in (first, second, third)
    # the repository's own: kabsch_fit.cu includes horn_fit.cuh
    assert (cuda_lib.CSRC / "horn_fit.cuh").resolve() in \
        cuda_lib.included_sources(cuda_lib.CSRC / "kabsch_fit.cu")


def test_build_path_covers_the_source(tmp_path):
    src = cuda_lib.CSRC / "keypoints.cu"
    assert keypoints._LIB.source == src
    assert cuda_lib.included_sources(src) == [src.resolve(),
                                              HEADER.resolve()]
    flags = cuda_lib.NVCC_FLAGS
    assert "-fmad=false" in flags
    copy = tmp_path / "keypoints.cu"
    shutil.copy(src, copy)
    shutil.copy(HEADER, tmp_path / HEADER.name)
    first = cuda_lib.compiled_path(copy, flags)
    assert first.name.startswith("keypoints_")
    assert first == cuda_lib.compiled_path(src, flags)
    copy.write_text(copy.read_text() + "\n// changed\n")
    assert cuda_lib.compiled_path(copy, flags) != first


def test_every_kernel_source_counts_through_the_header():
    """Each ``csrc/*.cu`` but the plumbing includes ``launch_counter.cuh``,
    finds its counters at load, emits the counter's entry points under its
    own name and keeps no counter of its own; each has exactly one
    registered ``Library`` (made by its ``ops/`` module), and the plumbing
    none."""
    _import_ops()
    names = [lib.name for lib in cuda_lib.registered()]
    assert len(names) == len(set(names))
    sources = sorted(cuda_lib.CSRC.glob("*.cu"))
    assert {s.stem for s in sources} >= PLUMBING
    for src in sources:
        text = src.read_text()
        counted = src.stem not in PLUMBING
        assert (HEADER.resolve() in cuda_lib.included_sources(src)) \
            == counted, src.name
        assert names.count(src.stem) == int(counted), src.name
        assert "__device__ unsigned long long" not in text, src.name
        if counted:
            assert f"LAUNCH_COUNTER_ENTRY_POINTS({src.stem})" in text
            assert "find_launch_counters()" in text
            assert "launch_counter(counted" in text
    assert sorted(names) == sorted(s.stem for s in sources
                                   if s.stem not in PLUMBING)
    assert all(lib.source.exists() for lib in cuda_lib.registered())


# A host-only stand-in with a counted library's entry points (gcc builds
# it here; a csrc/ library builds only where nvcc is)
STAND_IN = """
int stand_in_width(void) { return 7; }
int stand_in_load(void) { return LOAD_RC; }
const char* stand_in_error(int err) { return err == 3 ? "three" : "other"; }
int stand_in_launch_modes(void) { return 2; }
int stand_in_read_launches(unsigned long long* v) { v[0] = 4; v[1] = 5; return 0; }
int stand_in_reset_launches(void) { return 0; }
int stand_in_twice(int x) { return 2 * x; }
"""


def test_library_binds_checks_its_constants_and_loads(tmp_path, monkeypatch):
    """``Library.library()`` binds the module's entry points and the
    pattern's, checks the constants and the number of counters against
    the library's, and raises with the library's own message where its
    load fails; ``check`` does the same for an entry point's code."""
    src = tmp_path / "stand_in.c"
    src.write_text(STAND_IN)

    def build(rc):
        out = tmp_path / f"stand_in_{rc}.so"
        subprocess.run(["gcc", "-shared", "-fPIC", f"-DLOAD_RC={rc}", "-o",
                        str(out), str(src)], check=True)
        return out

    def bind(lib):
        lib.stand_in_twice.argtypes = [ctypes.c_int]
        lib.stand_in_twice.restype = ctypes.c_int

    def library(path, **kw):
        cuda_lib._registry.pop("stand_in", None)
        lib = cuda_lib.Library("stand_in", bind, **kw)
        monkeypatch.setattr(lib, "build", lambda: path)
        return lib

    ok, failing = build(0), build(3)
    try:
        lib = library(ok, constants={"width": 7}, modes=("a", "b"))
        assert lib in cuda_lib.registered() and not lib.loaded
        assert lib.library().stand_in_twice(21) == 42 and lib.loaded
        lib.check(0, "fine")
        with pytest.raises(RuntimeError, match=r"a call: CUDA error 3 "
                                               r"\(three\)"):
            lib.check(3, "a call")
        with pytest.raises(ValueError, match="second library"):
            cuda_lib.Library("stand_in", bind)
        for kw, what in (({"constants": {"width": 8}, "modes": ("a", "b")},
                          "width 7, its module 8"),
                         ({"modes": ("a",)}, "launch_modes 2, its module 1")):
            lib = library(ok, **kw)
            with pytest.raises(RuntimeError, match=what):
                lib.library()
            assert not lib.loaded
        lib = library(failing, modes=("a", "b"))
        with pytest.raises(RuntimeError, match=r"loading the stand_in "
                                               r"kernels: CUDA error 3"):
            lib.library()
        assert not lib.loaded
        assert library(ok, counted=False) not in cuda_lib.registered()
    finally:
        cuda_lib._registry.pop("stand_in", None)


def test_launch_counts_are_empty_before_any_load():
    """In a process that has made every library but loaded none, the
    registry reads no counter and the recorder's snapshot reports none."""
    code = ("import importlib, pkgutil\n"
            "import putslam_tpu_torch.ops as ops\n"
            "for m in pkgutil.iter_modules(ops.__path__):\n"
            "    importlib.import_module('putslam_tpu_torch.ops.' + m.name)\n"
            "from putslam_tpu_torch.utils import cuda_lib, timing\n"
            "assert len(cuda_lib.registered()) == 7, cuda_lib.registered()\n"
            "assert not any(lib.loaded for lib in cuda_lib.registered())\n"
            "assert cuda_lib.launch_counts() == {}\n"
            "assert timing.snapshot()['launches'] == {}\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_utils_never_import_ops():
    """``utils/`` is the bottom layer: none of its modules imports
    ``putslam_tpu_torch.ops``, and the loader imports nothing else of the
    package at module level."""
    files = sorted((PKG / "utils").glob("*.py"))
    assert PKG / "utils" / "cuda_lib.py" in files
    for f in files:
        names = list(_imported(ast.parse(f.read_text())))
        assert not [n for n in names
                    if n.startswith("putslam_tpu_torch.ops")], f.name
    top = [node for node in
           ast.parse((PKG / "utils" / "cuda_lib.py").read_text()).body
           if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert not [n for n in _imported(ast.Module(body=top, type_ignores=[]))
                if n.startswith("putslam_tpu_torch")]


def test_ctypes_loads_the_cuda_libraries_in_one_place():
    """``ctypes.CDLL`` occurs on one line of ``utils/cuda_lib.py`` and
    nowhere else in the package but the host PNG decoder's loader
    (``io/native_loader.py``: ``native/``, built by make, not a ``csrc/``
    library)."""
    found = {}
    for f in sorted(PKG.rglob("*.py")):
        n = sum("ctypes.CDLL" in line for line in f.read_text().splitlines())
        if n:
            found[str(f.relative_to(PKG))] = n
    assert found.pop("utils/cuda_lib.py") == 1
    assert set(found) <= {"io/native_loader.py"}
    assert "csrc" not in (PKG / "io" / "native_loader.py").read_text()


_GLOBAL = re.compile(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                     r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def test_roofline_kernel_names_are_kernels():
    """Each ``KERNEL`` fragment of ``slambench/roofline/*.py`` (matched
    against the demangled names of a trace) names a ``__global__`` of
    ``csrc/``; a fragment with template arguments names a template whose
    first parameter takes them. Reads those files and edits none."""
    kernels = {}
    for src in cuda_lib.CSRC.glob("*.cu"):
        for params, name in _GLOBAL.findall(src.read_text()):
            kernels[name] = params
    assert "fast_score_nms_kernel" in kernels
    fragments = []
    for f in sorted((ROOT / "slambench" / "roofline").glob("*.py")):
        m = re.search(r'^KERNEL = "([^"]+)"', f.read_text(), re.M)
        assert m, f.name
        fragments.append(m.group(1))
    assert len(fragments) >= 3
    for frag in fragments:
        name, _, args = frag.partition("<")
        assert name in kernels, frag
        if args:            # "<true": the template's first argument, a bool
            first = kernels[name].split(",")[0].split()
            assert first[:1] == ["bool"] and args in ("true", "false"), frag
