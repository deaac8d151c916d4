"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness finds, with no table in code:

- a configuration's file at the ``file`` its ``configs`` entry gives;
- a traffic mix at ``bench/traffic/<traffic>.json``;
- a metric's reader at ``bench/metrics/<name>.py`` (``read(run)``);
- a check's reader at ``bench/checks/<name>.py`` (``reading(ctx)``), for
  each check the configuration's ``correct`` section names;
- the data generator at ``bench/datasets/<data.generator>.py``;
- the system under test at ``bench/systems/<system>.py``.

So a new configuration, traffic mix, metric or check is new files plus new
entries in ``BENCHMARK.json``, with no edit to a file that exists.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One resolved cell: its entry, its configuration and traffic files'
    contents, and the metrics it reports in each mode."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_benchmark(root: pathlib.Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, every file it
    names read; raises KeyError / FileNotFoundError for what is missing."""
    root = pathlib.Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload, workload=w, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, workload)])


def reader_path(root: pathlib.Path, kind: str, name: str) -> pathlib.Path:
    """``bench/<kind>/<name>.py`` (kind: metrics, checks, datasets,
    systems)."""
    return pathlib.Path(root) / "bench" / kind / f"{name}.py"


def load_module(path: pathlib.Path):
    """Import one reader file by its path (its name may hold dots)."""
    path = pathlib.Path(path)
    key = "bench._loaded." + re.sub(r"\W", "_", str(path.resolve()))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def load_reader(root: pathlib.Path, kind: str, name: str):
    path = reader_path(root, kind, name)
    if not path.exists():
        raise FileNotFoundError(f"no {kind} reader for {name!r}: {path}")
    return load_module(path)
