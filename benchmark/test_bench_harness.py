"""The harness on the CPU: ``BENCHMARK.json`` against its contract, cells
found by name with nothing edited, the result line's keys, the refusal
without a card, and the modules a run may load."""

from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest

import sdfkit_tpu_torch as st

from benchmark.harness import result, spec

BENCH = spec.HERE
ROOT = spec.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_its_contract():
    b = _bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.fullmatch(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and TEXT.fullmatch(c["why"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] == []
        assert config["source"] == c["source"]
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and TEXT.fullmatch(w["why"])
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "loops" / f"{mix['loop']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    end = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in end and end["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.fullmatch(m["layer"]) and m["moves"] in end
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = end[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved), m["name"]
    for cell in cells:
        reported = [m for m in b["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _digest(folder: pathlib.Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """In a copy, a configuration, a traffic mix with a loop of its own, a
    limits file and a per-layer metric are added as new files and entries;
    the harness finds each by its name, and no file that was there changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digest(copy)
    config = json.loads((copy / "benchmark/configs/sphere_repeat_1080p.json").read_text())
    config.update(name="sphere_repeat_2160p", render={**config["render"], "width": 3840,
                                                      "height": 2160})
    (copy / "benchmark/configs/sphere_repeat_2160p.json").write_text(json.dumps(config))
    (copy / "benchmark/traffic/frames_still.json").write_text(json.dumps({"loop": "still"}))
    (copy / "benchmark/loops/still.py").write_text(
        "def run(*args):\n    return 'still'\n\n\ndef control_readings(*args):\n    return {}\n")
    (copy / "benchmark/limits/sphere_repeat_2160p.frames_still.json").write_text(
        (copy / "benchmark/limits/sphere_repeat_1080p.frames_orbit.json").read_text())
    (copy / "benchmark/metrics/frames.count.frame.py").write_text(
        "def read(ctx):\n    return float(ctx['count'])\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sphere_repeat_2160p", "source": config["source"],
                             "file": "benchmark/configs/sphere_repeat_2160p.json",
                             "reduced": [], "why": "4K"})
    bench["workloads"].append({"name": "sphere_repeat_2160p.frames_still",
                               "config": "sphere_repeat_2160p", "traffic": "frames_still",
                               "chips": 1, "why": "4K frames"})
    bench["per_layer"].append({"name": "frames.count.frame", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "setup_s",
                               "workloads": ["sphere_repeat_2160p.frames_still"]})
    new_bench = tmp_path / "BENCHMARK.json"
    new_bench.write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "ROOT", copy)
    monkeypatch.setattr(spec, "HERE", copy / "benchmark")
    cell = spec.load_cell("sphere_repeat_2160p.frames_still", new_bench)
    assert cell.config["render"]["width"] == 3840 and cell.traffic == {"loop": "still"}
    assert spec.loop(cell.traffic["loop"]).run() == "still"
    assert [m["name"] for m in cell.per_layer if m["name"] == "frames.count.frame"]
    assert spec.metric_reader("frames.count.frame")({"count": 7}) == 7.0
    assert _digest(copy) == {**before, **{k: v for k, v in _digest(copy).items()
                                          if k not in before}}


def test_the_last_line_has_the_contract_keys():
    """A run on the CPU at 64x36, with the look for a card skipped: the
    line's keys are the contract's, ``breakdown`` only where traced, and
    ``checks``, each number beside its limit, last."""
    st.set_default_device("cpu")
    try:
        for name in ("sphere_repeat_1080p.frames_orbit", "union_grid_4_1080p.fit_colours",
                     "union_grid_200_1080p.fit_colours"):
            cell = spec.load_cell(name)
            cell.config["render"].update(width=32, height=18)
            for traced in (False, True):
                line = result.run(cell, 2**33 + 5, 0.3, traced, "cpu", time.perf_counter())
                keys = list(line)
                assert keys[:5] == list(REQUIRED) and keys[-1] == "checks"
                assert set(keys) == set(REQUIRED) | {"builds", "setup", "checks"} | (
                    {"breakdown"} if traced else set())
                assert line["correct"] is True
                for c in line["checks"].values():
                    assert set(c) == {"value", "limit"}
                names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
                assert set(line["metrics"]) <= names
                if not traced:  # every end-to-end metric of the cell, "step_ms.small" too,
                    # but a device clock, which a run on the CPU has nothing to read for
                    on_card = {m["name"] for m in cell.end_to_end if m["source"] == "device_trace"}
                    assert set(line["metrics"]) == names - on_card and "setup_s" in names
                json.dumps(line)
    finally:
        st.set_default_device(None)


def test_the_harness_refuses_to_run_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "sphere_repeat_1080p.frames_orbit", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "union_grid_200_1080p.fit_colours", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["sdfkit_tpu_torch", "sdfkit_tpu_torch.fit", "jaxtyping", "flaxen", "numpy",
             "jax.numpy", "jaxlib", "flax.linen", "sdfkit_tpu", "sdfkit_tpu.ops"]
    assert result.forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "sdfkit_tpu",
                                               "sdfkit_tpu.ops"]


def test_a_chip_run_imports_no_jax_and_the_reference_none_of_the_program():
    """What run.py imports for a run, every metric reader, the control and
    the reference, in a fresh interpreter: no module of JAX or the JAX
    package; and the reference's own modules import nothing of the port."""
    code = (
        "import sys, pathlib; sys.path.insert(0, '.');"
        "import benchmark.reference.render, benchmark.reference.sphere_repeat,"
        " benchmark.reference.union_grid;"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'sdfkit_tpu_torch'];"
        "import benchmark.harness.result, benchmark.harness.window, benchmark.control,"
        " benchmark.scenes.sphere_repeat, benchmark.scenes.union_grid;"
        "from benchmark.harness import spec;"
        "[spec.loop(p.stem) for p in pathlib.Path('benchmark/loops').glob('[a-z]*.py')];"
        "[spec.metric_reader(p.stem) for p in pathlib.Path('benchmark/metrics').glob('*.py')];"
        "from benchmark.harness.result import forbidden_modules;"
        "print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                for m in mods:
                    assert m.split(".")[0] not in ("sdfkit_tpu_torch", "sdfkit_tpu", "jax"), (
                        path, m)
