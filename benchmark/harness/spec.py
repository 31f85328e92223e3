"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and the loop the mix names (``loops/<loop>.py``),
its limits (``limits/<cell>.json``), the scene kind's reference
(``reference/<kind>.py``) and port builder (``scenes/<kind>.py``), and the
readers of the per-layer metrics (``metrics/<metric>.py``). No list of them
is written in the code: a file added under one of these folders and named in
``BENCHMARK.json`` is found.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries of BENCHMARK.json this cell reports
    per_layer: list


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench_path: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names."""
    bench = read_json(bench_path or ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {known})")
    w = found[0]
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=read_json(ROOT / config_entry["file"]),
        traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def scene_modules(kind: str):
    """(the reference's module, the port builder's module) of a scene kind."""
    return (importlib.import_module(f"benchmark.reference.{kind}"),
            importlib.import_module(f"benchmark.scenes.{kind}"))


def _load(path: pathlib.Path, name: str):
    """The module of the file ``path``, under ``name`` (loaded once)."""
    if name in sys.modules and sys.modules[name].__file__ == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def loop(name: str):
    """The module ``loops/<name>.py``: ``run`` and ``control_readings``."""
    return _load(HERE / "loops" / f"{name}.py", f"benchmark.loops.{name}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run gives it nothing to read."""
    return _load(HERE / "metrics" / f"{name}.py",
                 f"benchmark_metric_{name.replace('.', '_')}").read
