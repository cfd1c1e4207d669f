"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  Each lives in a file of
its own: the configuration's under the path its ``file`` entry gives,
the mix at ``traffic/<name>.json`` (run on each of the cell's
``chips`` ranks; a mix that holds only ``each_rank`` runs the mix it
names), the cell's correctness limits at
``limits/<cell>.json`` and each per-layer metric's reader at
``metrics/<name>.py``.  Adding a cell, a mix or a metric adds files and
entries and edits none.

``bench_dirs`` are searched in order for the mix, limit and metric
files, so a test can lay a throwaway cell over the real directory.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]
    read: Optional[Callable] = None   # per-layer metrics only


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _find(bench_dirs: Sequence[Path], rel: str) -> Path:
    for d in bench_dirs:
        p = Path(d) / rel
        if p.is_file():
            return p
    raise FileNotFoundError(
        f"{rel} is in none of {[str(d) for d in bench_dirs]}")


def _load_reader(path: Path) -> Callable:
    mod_name = "hvdbench_metric_" + \
        path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metric(entry: dict) -> Metric:
    return Metric(name=entry["name"], unit=entry["unit"],
                  workloads=entry.get("workloads"))


def _reports(m: Metric, cell: str) -> bool:
    return m.workloads is None or cell in m.workloads


def load_cell(workload: str, root: Path = ROOT,
              bench_dirs: Optional[Sequence[Path]] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, mix, limits and the metrics it reports."""
    root = Path(root)
    bench_dirs = [Path(d) for d in (bench_dirs or [HERE])]
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(_find(bench_dirs, f"traffic/{w['traffic']}.json"))
    if "each_rank" in traffic:
        # A mix of several ranks named apart from its one-rank mix (a
        # pair of configuration and mix is one cell) runs that mix.
        traffic = _read_json(_find(bench_dirs,
                                   f"traffic/{traffic['each_rank']}.json"))
    try:
        limits = _read_json(_find(bench_dirs, f"limits/{workload}.json"))
    except FileNotFoundError:
        limits = {}
    e2e = [_metric(m) for m in bench["end_to_end"]
           if _reports(_metric(m), workload)]
    layer = []
    for entry in bench["per_layer"]:
        m = _metric(entry)
        if _reports(m, workload):
            m.read = _load_reader(_find(bench_dirs, f"metrics/{m.name}.py"))
            layer.append(m)
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer)


def bench_dirs_for(root: Path) -> List[Path]:
    """``root/hvdbench`` (when it is not this directory) before this
    one: a throwaway cell's files first, the real readers after."""
    local = Path(root) / "hvdbench"
    return [local, HERE] if local.resolve() != HERE else [HERE]

