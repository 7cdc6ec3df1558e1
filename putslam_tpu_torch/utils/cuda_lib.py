"""Build, load, bind and count the port's hand-written CUDA libraries.

Each ``csrc/<name>.cu`` is one ``Library``. It is compiled with ``nvcc``
(``NVCC_FLAGS``: ``sm_90a``, no contraction of multiplies and adds) at its
first use into ``putslam_tpu_torch/build/``, named by a hash of the source,
the headers it includes and the flags, so a fresh checkout builds it on its
first CUDA call and a changed source or header builds anew; what nvcc and
``ptxas -v`` printed is kept beside it (``build_log``). It is loaded with
``ctypes``, and its module's ``bind`` declares the argument and result
types of its own entry points.

Every library's plain C entry points follow one pattern, ``<name>`` the
source's stem: ``<name>_load`` loads its kernels on the current device
before any capture (lazy module loading would load them at their first
launch, which may lie inside a capture, where loading is not permitted) and
``<name>_error`` names a ``cudaError_t``; ``<name>_<suffix>()`` returns
each of the ``constants`` its module checks once at load.

A counted library (every kernel; not the plumbing of ``graph_cond`` and
``stamp``) includes ``csrc/launch_counter.cuh``: a launch adds one to a
counter on the card, since a launch recorded into a CUDA graph, inside a
conditional node's body, runs at a replay only where the card takes the
branch, which the host does not see. Launches made under ``uncounted()``
(the warm-up before a capture) go to a second counter that nothing reads.
Each counted library joins the registry when it is made, and
``launch_counts()`` reads the counters of those that are loaded.

This module imports nothing else of the package but, inside
``compile_library``, the flight recorder's ``build`` span.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_registry: Dict[str, "Library"] = {}
_counted = True


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc "
                           "on PATH): cannot build the CUDA libraries")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def included_sources(source: Path) -> List[Path]:
    """``source`` and every file it includes with ``#include "..."``,
    directly or through another such file (paths relative to the including
    file), each once, in the order first met."""
    seen: List[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [(path.parent / m.decode()).resolve()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def compiled_path(source: Path, flags: Sequence[str]) -> Path:
    """Where ``compile_library`` puts ``source`` built with ``flags``: named
    by a hash of both and of the headers the source includes, so that a
    changed header builds anew."""
    h = hashlib.sha256()
    for path in included_sources(source):
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def compile_library(source: Path, flags: Sequence[str]) -> Path:
    """Compile ``source`` with ``nvcc`` and ``flags`` into a shared library
    in ``BUILD_DIR`` unless it is built already; what nvcc printed is kept
    beside it (``.log``). Returns its path. Raises with the compiler's
    output on failure. A build is the flight recorder's ``build`` span."""
    from putslam_tpu_torch.utils import timing

    out = compiled_path(source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *flags, "-o", tmp, str(source)]
        with timing.span("build"):
            proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block are not counted (the warm-up pass
    before a capture, which is not a step)."""
    global _counted
    old, _counted = _counted, False
    try:
        yield
    finally:
        _counted = old


def counted() -> int:
    """The ``counted`` argument of a launch: 1, or 0 under ``uncounted``."""
    return int(_counted)


class Library:
    """The library built from ``csrc/<name>.cu``, loaded on first use.
    ``bind(lib)`` declares the argument and result types of its own entry
    points; ``constants`` ({suffix: value}) are checked against
    ``<name>_<suffix>()`` once, at load. A ``counted`` library joins the
    registry; ``modes`` names its counters where it has more than one."""

    def __init__(self, name: str, bind: Callable, *,
                 constants: Optional[Mapping[str, int]] = None,
                 modes: Sequence[str] = (), counted: bool = True):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self.constants = dict(constants or {})
        self.modes = tuple(modes)
        self.counted = counted
        self._lib = None
        if counted:
            if name in _registry:
                raise ValueError(f"a second library named {name!r}")
            _registry[name] = self

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def build(self) -> Path:
        """Compile the library unless it is built already; returns its
        path. Raises with the compiler's output on failure."""
        return compile_library(self.source, NVCC_FLAGS)

    def build_log(self) -> str:
        """What nvcc and ``ptxas -v`` printed when the library was built:
        registers, shared memory and spills of each kernel."""
        return self.build().with_suffix(".log").read_text()

    def _fn(self, lib, suffix):
        return getattr(lib, f"{self.name}_{suffix}")

    def _declare(self, lib, suffix, args=(), restype=ctypes.c_int):
        fn = self._fn(lib, suffix)
        fn.argtypes, fn.restype = list(args), restype

    def library(self):
        """The loaded library (``ctypes``), its kernels loaded on the
        current device."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            constants = dict(self.constants)
            if self.counted:
                constants["launch_modes"] = len(self.modes) or 1
                self._declare(lib, "reset_launches")
                self._declare(lib, "read_launches",
                              [ctypes.POINTER(ctypes.c_ulonglong)])
            for suffix in (*constants, "load"):
                self._declare(lib, suffix)
            self._declare(lib, "error", [ctypes.c_int], ctypes.c_char_p)
            for suffix, want in constants.items():
                got = self._fn(lib, suffix)()
                if got != want:
                    raise RuntimeError(f"csrc/{self.name}.cu has {suffix} "
                                       f"{got}, its module {want}")
            self._check(lib, self._fn(lib, "load")(),
                        f"loading the {self.name} kernels")
            self._lib = lib
        return self._lib

    def _check(self, lib, rc: int, what: str) -> None:
        if rc:
            msg = self._fn(lib, "error")(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

    def check(self, rc: int, what: str) -> None:
        """Raise where an entry point returned a CUDA error."""
        self._check(self.library(), rc, what)

    def launch_counts(self, device="cuda") -> Dict[str, int]:
        """Counted launches on ``device`` since the last reset, graph
        replays included, by counter: ``{name: n}``, or ``{name.mode: n}``
        per mode (synchronises the device)."""
        keys = [f"{self.name}.{m}" for m in self.modes] or [self.name]
        with torch.cuda.device(torch.device(device)):
            lib = self.library()
            torch.cuda.synchronize()
            values = (ctypes.c_ulonglong * len(keys))()
            self._check(lib, self._fn(lib, "read_launches")(values),
                        "reading the launch count")
        return {k: int(v) for k, v in zip(keys, values)}

    def launch_count(self, device="cuda") -> int:
        """Counted launches on ``device`` since the last reset, all modes
        (synchronises the device)."""
        return sum(self.launch_counts(device).values())

    def reset_launch_count(self, device="cuda") -> None:
        """Set the launch counts on ``device`` to 0 (synchronises the
        device)."""
        with torch.cuda.device(torch.device(device)):
            lib = self.library()
            torch.cuda.synchronize()
            self._check(lib, self._fn(lib, "reset_launches")(),
                        "resetting the launch count")


def registered() -> List[Library]:
    """Every counted library made in this process, in the order made."""
    return list(_registry.values())


def launch_counts(device="cuda") -> Dict[str, int]:
    """The launch counters of the counted libraries that are loaded (each
    read with a synchronise): ``Library.launch_counts`` of each."""
    out: Dict[str, int] = {}
    for lib in _registry.values():
        if lib.loaded:
            out.update(lib.launch_counts(device))
    return out
