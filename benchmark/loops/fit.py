"""The ``fit`` loop: ``sdfkit_tpu_torch.fit`` of the configuration's
``fit.train`` leaves with Adam toward the reference's render of the
``fit.target`` table, from the ``fit.start`` table. Set-up runs the first
``warm_steps`` steps through ``fit``; the window is one more ``fit`` call
that goes on from the same scene and optimizer state, with as many steps as
fill it at the pace the set-up's last step showed. It reports ``step_ms``
(the window over its steps) and ``setup_s``, which leaves out the
reference's render of the target.

The check follows the program with the reference from the seed through
the set-up's steps and the window's first ``window_steps_followed`` (at
least 1): each of those steps' loss, the first gradient as the optimizer
got it, and the parameters' change over them. And the window's last step:
its loss against the reference's loss at the parameters that step
rendered, which the program's state after the step before holds (the
reference does not follow every step of the window).
"""

from __future__ import annotations

import math
import threading
import time

import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.sdf.compile import compile_scene

from benchmark.harness import check, faults, generate, spec
from benchmark.harness import window as w
from benchmark.reference import render as ref


def _prebuild(expr, device) -> None:
    """Start the forward's and the backward's nvcc together, where this
    checkout has not built them yet: two threads, each waiting on its own
    compiler. A warm checkout loads both at once."""
    if not w.on_card(device):
        return
    program = compile_scene(expr)
    errors = []

    def load(fn):
        try:
            fn(program)
        except Exception as e:  # noqa: BLE001 -- re-raised below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=load, args=(fn,)) for fn in (build.load, build.load_bwd)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _inputs(cell: spec.Cell, seed: int, device) -> dict:
    """The fit's settings and its tables, the same for the program and the
    control."""
    config = cell.config
    plan = config["fit"]
    ref_mod, port_mod = spec.scene_modules(config["scene"]["kind"])
    table = ref_mod.table(config["scene"], device)
    return {"cfg": generate.render_config(config), "train": plan["train"],
            "lr": float(plan["lr"]), "ref_mod": ref_mod, "port_mod": port_mod,
            "view": generate.fixed_view(config["view"], device),
            "start": generate.drawn(table, plan.get("start", {}), seed, "start", device),
            "aim": generate.drawn(table, plan.get("target", {}), seed, "target", device),
            "followed": int(cell.traffic["warm_steps"]) + int(
                cell.traffic["window_steps_followed"])}


def _with_rows(table: dict, name: str, rows: list) -> dict:
    """``table`` with entry ``name`` made of ``rows``, one leaf's values each."""
    out = dict(table)
    out[name] = torch.stack([r.reshape(-1) for r in rows]).reshape(table[name].shape)
    return out


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> w.Outcome:
    warm_steps = int(cell.traffic["warm_steps"])
    followed = int(cell.traffic["window_steps_followed"])
    x = _inputs(cell, seed, device)
    cfg, train, lr, ref_mod, port_mod = x["cfg"], x["train"], x["lr"], x["ref_mod"], x["port_mod"]
    view, start = x["view"], x["start"]
    t_ref = time.perf_counter()
    setup = {"inputs": t_ref - t0}
    target = ref.render(ref_mod, x["aim"], view, cfg)
    w.sync(device)
    reference_s = time.perf_counter() - t_ref  # the reference's own time: not in setup_s
    setup["reference_s"] = reference_s
    w.free(device)
    if w.on_card(device):
        torch.cuda.reset_peak_memory_stats(device)

    t_build = time.perf_counter()
    expr = port_mod.build(start, device)
    _prebuild(expr, device)
    setup["libraries"] = time.perf_counter() - t0
    chosen = {id(p) for p in port_mod.leaves(expr, train)}
    index = [i for i, p in enumerate(st.leaves(expr)) if id(p) in chosen]
    state: dict = {}

    def optimizer(params):
        opt = torch.optim.Adam([params[i] for i in index], lr=lr)
        if "saved" in state:
            opt.load_state_dict(state["saved"])
        state["opt"] = opt
        return opt

    def trained() -> list:
        return [p.detach().clone() for p in state["opt"].param_groups[0]["params"]]

    marks, first_grads = [], []

    def warm_progress(step, loss):
        marks.append(time.perf_counter())
        if step == 0:
            opt = state["opt"]
            beta1 = opt.param_groups[0]["betas"][0]
            for p in opt.param_groups[0]["params"]:
                # An optimizer that kept no state got no gradient it shows: NaN fails.
                m = opt.state.get(p, {}).get("exp_avg")
                first_grads.append(torch.full_like(p, math.nan) if m is None
                                   else m.detach() / (1 - beta1))

    kwargs = generate.march_kwargs(cfg)
    warm = st.fit(expr, target, steps=warm_steps, view=view, optimizer=optimizer,
                  progress=warm_progress, **kwargs)
    first_frame_s = marks[0] - t_build
    setup["first_step"], setup["warm_steps"] = marks[0] - t0, marks[-1] - t0
    pace = marks[-1] - marks[-2]
    builds = build.BUILDS
    state["saved"] = state["opt"].state_dict()
    losses = list(warm.losses)
    before = [p.detach().clone() for p in port_mod.leaves(expr, train)]

    limit = w.window_seconds(seconds, traced)
    steps = max(followed + 1, math.ceil(limit / pace))
    snaps: dict = {}

    def window_progress(step, loss):
        if step == followed - 1:
            snaps["followed"] = trained()
        if step == steps - 2:
            snaps["last"] = trained()  # what the last step renders

    def one_step():
        st.fit(warm.sdf, target, steps=1, view=view, optimizer=lambda p: torch.optim.Adam(p),
               **kwargs)

    with w.Profiled(traced, device, one_step) as prof:
        launches0 = (rk.LAUNCHES, rk.BWD_LAUNCHES)
        t_start = time.perf_counter()
        result = st.fit(warm.sdf, target, steps=steps, view=view, optimizer=optimizer,
                        progress=window_progress, **kwargs)
    w.sync(device)
    window_s = time.perf_counter() - t_start
    launches = (rk.LAUNCHES - launches0[0], rk.BWD_LAUNCHES - launches0[1])
    peak = w.peak(device)
    summary = prof.reduce()
    window_losses = list(result.losses)
    del result, warm, expr, state
    w.free(device)

    ref_losses, ref_grads, ref_params = ref.fit_steps(ref_mod, start, view, target, cfg, train,
                                                      lr, x["followed"])
    ref_last = ref.frame_loss(ref_mod, _with_rows(start, train, snaps["last"]), view, target,
                              cfg)
    pairs = list(zip(losses + window_losses[:followed], ref_losses))
    pairs.append((window_losses[-1], ref_last))
    rows = len(index)
    numbers = check.fit_numbers(
        pairs, first_grads, list(ref_grads.reshape(rows, -1)),
        [a - b for a, b in zip(snaps["followed"], before)],
        list((ref_params[train] - start[train]).reshape(rows, -1)), window_losses)
    expected = steps if w.on_card(device) else 0
    numbers["launch_gap"] = abs(launches[0] - expected) + abs(launches[1] - expected)
    checks = check.judge(numbers, cell.limits)
    late = sum(g > cell.limits["loss_gap"] for g in check.loss_gaps(pairs)[warm_steps:])
    failed = late + int(numbers["nonfinite"])
    if not all(c.ok for c in checks):
        failed = max(failed, 1)
    ctx = {"loop": "fit", "config": cell.config, "count": steps,
           "first_frame_s": first_frame_s, "summary": summary}
    if traced:
        ctx["needs"] = ref.march_needs(ref_mod, x["aim"], view, cfg)
    return w.Outcome(attempted=steps, failed=failed,
                     end_to_end={"step_ms": window_s / steps * 1e3,
                                 "setup_s": t_start - t0 - reference_s},
                     ctx=ctx, checks=checks, setup=setup, memory_peak_bytes=peak,
                     builds=builds)


def control_readings(cell: spec.Cell, seed: int, device) -> dict:
    """{kind: numbers} of the control and the faults, each put in the
    program's place over the steps a run follows, against the float32
    reference from the same start; the last pair of losses is each one's
    loss at the parameters it reached against the reference's there."""
    x = _inputs(cell, seed, device)
    cfg, train, lr, ref_mod, view, start = (x["cfg"], x["train"], x["lr"], x["ref_mod"],
                                            x["view"], x["start"])
    target = ref.render(ref_mod, x["aim"], view, cfg)
    rows = start[train].shape[0] if start[train].ndim == 2 else 1  # one leaf a row

    def follow(at=view, **kinds):
        losses, grad, after = ref.fit_steps(ref_mod, start, at, target, cfg, train, lr,
                                            x["followed"], **kinds)
        last = float(ref.loss_and_grads(ref_mod, after, at, target, cfg, **kinds)[0])
        return (losses, list(grad.reshape(rows, -1)),
                list((after[train] - start[train]).reshape(rows, -1)), last, after)

    want = follow()
    out = {}
    for kind, kinds in (("control", {"dtype": faults.LOW}),
                        ("half_rows", {"rows_kept": slice(0, cfg["height"] // 2)}),
                        ("altered", {"alter": faults.alter}),
                        ("nudged", {"at": faults.nudged(cell.config["view"], device)})):
        got = follow(**kinds)
        pairs = list(zip(got[0], want[0]))
        pairs.append((got[3], ref.frame_loss(ref_mod, got[4], view, target, cfg)))
        out[kind] = check.fit_numbers(pairs, got[1], want[1], got[2], want[2], got[0])
    return out
