"""Where the benchmark finds what a cell is made of, by name alone:
``BENCHMARK.json`` at the checkout's root names a cell's configuration and
traffic mix; ``configs/<config>.json`` holds the configuration,
``traffic/<mix>.json`` the traffic, ``metrics/<metric>.py`` the reader of
each per-layer metric and ``roofline/<kernel>.py`` the operations and
bytes of a kernel. A later cell, mix, metric or kernel is a new file, and
no file that is there changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, its ``name`` added
    traffic: dict         # the traffic file, its ``name`` added
    end_to_end: list      # BENCHMARK.json's entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def names(kind: str, suffix: str, here: Path = HERE) -> list:
    """The names of the files of one kind (``configs``, ``traffic``,
    ``metrics``, ``roofline``) found under ``here``."""
    return sorted(p.name[:-len(suffix)] for p in (here / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files read."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(load_json(root / conf["file"]), name=w["config"])
    traffic = dict(load_json(here / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_module(kind: str, name: str, here: Path = HERE):
    """``<kind>/<name>.py`` as a module (its name may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def slam_config(overrides: dict):
    """``tum_fr1_config()`` with a configuration file's ``slam`` overrides:
    a key naming a group (``camera``, ``loop_closure``, …) takes a dict of
    that group's fields; a top-level field takes its value."""
    from putslam_tpu_torch.config import tum_fr1_config

    cfg = tum_fr1_config()
    for key, value in overrides.items():
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur):
            value = dataclasses.replace(cur, **value)
        cfg = cfg.replace(**{key: value})
    return cfg
