"""The port's host spans around the benchmark's runs: what they cost when on,
and how a process's set-up and first fit step split among them.

    python tools/torch_spans.py cost --workload union_grid_4_1080p.fit_colours \\
        --seeds 11 12 13 14 15 16 --seconds 10
    python tools/torch_spans.py first-step --workload union_grid_4_1080p.fit_colours --seed 11

``cost`` runs ``benchmark/run.py`` untraced once with spans off and once
with ``spans.enable()`` for each seed, each run a process of its own, the
order turned about from seed to seed (off, on; on, off; ...), and prints a
JSON line a run (with spans on, also the window's spans: milliseconds a
step or frame by name, with no profiler running), then one with each
end-to-end metric's median and quartiles a side
(``statistics.quantiles(n=4)``) and the medians' ratio.
``first-step`` runs one cell untraced with spans on from the start of the
process and prints, after the run's own lines, one JSON line: the first
fit step's (or first frame's) spans by name (count, total and self ms), the
spans outside any step (``sdf.fit.setup``, ``sdf.compile``, ``sdf.build``),
and the scene compiler's and the library loads' counters: among them the
programs traced with a union of like children as a loop (``LOOPED``), those
of them whose adjoints pull it back as a loop (``LOOPED_ADJOINTS``) and
each program's ``looped`` (its loops' children and share of the distance's
nodes, by the program's hash).

Run from the root of a checkout on a machine with a CUDA card, as the
benchmark is. ``run --spans on|off -- <run.py's arguments>`` is one such
run in this process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPS = ("sdf.fit.step", "sdf.frame")


def _run(spans_on: bool, first_step: bool, argv: list) -> int:
    """One benchmark run in this process, its spans on or off."""
    sys.path.insert(0, str(ROOT))
    from benchmark import run  # its clock of set-up starts here

    from sdfkit_tpu_torch.utils import spans

    if spans_on:
        spans.enable()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv)
    sys.stdout.write(out.getvalue())
    line = _json_line(out.getvalue(), "correct")
    if spans_on and line is not None:
        recs = spans.records()
        roots = [r.id for r in recs if r.name in TOPS and r.root == r.id][-line["attempted"]:]
        print(json.dumps({"window_ms_each": {
            name: s["total_ms"] / len(roots)
            for name, s in spans.summary(roots, recs).items()}}), flush=True)
    if first_step:
        from sdfkit_tpu_torch.render.cuda import build
        from sdfkit_tpu_torch.sdf import compile as sc

        recs = spans.records()
        first = next((r for r in recs if r.name in TOPS and r.root == r.id), None)
        print(json.dumps({
            "first": None if first is None else first.name,
            "first_spans": {} if first is None else spans.summary([first.id], recs),
            "outside_steps": spans.summary([None], recs),
            "compile_traces": sc.TRACES, "compile_s": sc.TRACE_SECONDS,
            "compile_looped": sc.LOOPED, "compile_looped_adjoints": sc.LOOPED_ADJOINTS,
            "looped": {prog.hash: list(prog.looped) for prog in sc._PROGRAMS.values()},
            "library_loads": build.LOADS, "libraries_s": build.LOAD_SECONDS,
            "dropped": spans.DROPPED}), flush=True)
    return rc


def _json_line(text: str, key: str) -> dict | None:
    """The last JSON line of ``text`` that has ``key`` (``"correct"``: the
    benchmark's result line)."""
    for line in reversed(text.splitlines()):
        if line.startswith("{") and key in json.loads(line):
            return json.loads(line)
    return None


def _cost(args) -> int:
    sides: dict = {"off": [], "on": []}
    for k, seed in enumerate(args.seeds):
        order = ("off", "on") if k % 2 == 0 else ("on", "off")
        for side in order:
            cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "run", "--spans", side,
                   "--", "--workload", args.workload, "--seed", str(seed), "--seconds",
                   str(args.seconds), "--trace", "0"]
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                  timeout=args.timeout)
            line = _json_line(proc.stdout, "correct")
            if proc.returncode != 0 or line is None:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode or 1
            metrics = {m: v["value"] for m, v in line["metrics"].items()}
            sides[side].append(metrics)
            print(json.dumps({"workload": args.workload, "seed": seed, "spans": side,
                              "correct": line["correct"], "metrics": metrics,
                              "window_ms_each": (_json_line(proc.stdout, "window_ms_each")
                                                 or {}).get("window_ms_each"),
                              "device": line["device"]["kind"],
                              "power_limit_w": line["device"]["power_limit_w"]}), flush=True)
    out = {}
    for name in sides["off"][0]:
        per = {}
        for side, runs in sides.items():
            values = [r[name] for r in runs]
            q1, med, q3 = statistics.quantiles(values, n=4)
            per[side] = {"median": statistics.median(values), "q1": q1, "q3": q3,
                         "spread": (q3 - q1) / statistics.median(values)}
        per["on_over_off"] = per["on"]["median"] / per["off"]["median"]
        out[name] = per
    print(json.dumps({"workload": args.workload, "runs": len(args.seeds), "summary": out}),
          flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("cost", help="spans off against spans on, a process a run")
    c.add_argument("--workload", required=True)
    c.add_argument("--seeds", type=int, nargs="+", required=True)
    c.add_argument("--seconds", type=float, default=10.0)
    c.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    f = sub.add_parser("first-step", help="one run, spans on from the start")
    f.add_argument("--workload", required=True)
    f.add_argument("--seed", type=int, required=True)
    f.add_argument("--seconds", type=float, default=10.0)
    r = sub.add_parser("run", help="one benchmark run in this process")
    r.add_argument("--spans", choices=("on", "off"), required=True)
    r.add_argument("rest", nargs=argparse.REMAINDER, help="-- then run.py's arguments")
    args = p.parse_args(argv)
    if args.mode == "cost":
        return _cost(args)
    if args.mode == "first-step":
        return _run(True, True, ["--workload", args.workload, "--seed", str(args.seed),
                                 "--seconds", str(args.seconds), "--trace", "0"])
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    return _run(args.spans == "on", False, rest)


if __name__ == "__main__":
    sys.exit(main())
