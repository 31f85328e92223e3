"""The check catches a broken timed path: the rest of a run, on the CPU at
64x36 with the look for a card skipped, with the program broken
underneath, gives ``correct`` false. Once for each fault a cell can have:
an answer altered where it is produced, half of the work left out (for a
fit, the mean taken over the rest), and for a fit a step that leaves its
state unchanged. One card has no exchange between cards to leave out.

Each fault of a fit also once in the window's ``fit`` call alone, with the
set-up's steps sound. The control (the reference in bfloat16 in the
program's place) fails the same limits at this size: ``control.py`` reads
it at the cells' own sizes on the card."""

from __future__ import annotations

import time

import pytest
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.parallel import train

from benchmark.harness import check, result, spec

SEED = 2**32 + 77


@pytest.fixture(autouse=True)
def on_the_cpu():
    st.set_default_device("cpu")
    yield
    st.set_default_device(None)


FIT = "union_grid_200_1080p.fit_colours"


def _cell(name: str) -> spec.Cell:
    """The cell at 64x36, the union grid's at 32x18 (its plain path on the
    CPU evaluates 200 spheres a step)."""
    cell = spec.load_cell(name)
    small = name.startswith("union_grid")
    cell.config["render"].update(width=32 if small else 64, height=18 if small else 36)
    return cell


def _run(name: str) -> dict:
    return result.run(_cell(name), SEED, 0.3, False, "cpu", time.perf_counter())


def _broken_frames(change):
    render = st.RayMarcher.render

    def broken(self, camera=None):
        return change(render(self, camera).clone())

    return broken


def _add_to_top_rows(frame):
    """A tenth more in the upper half's colours: more than the frames'
    limits let pass (they allow the kernels' drift on a fifth of the
    pixels, PERF.md)."""
    frame[: frame.shape[0] // 2] += 0.1
    return frame


def _drop_lower_half(frame):
    frame[frame.shape[0] // 2:] = 0.0
    return frame


def _in_the_window_only(monkeypatch, fault):
    """``st.fit`` with ``fault(monkeypatch)`` in force from its second call
    on (the window's; set-up makes the first), undone after each."""
    whole, calls = st.fit, []

    def fit(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return whole(*args, **kwargs)
        with pytest.MonkeyPatch.context() as m:
            fault(m)
            return whole(*args, **kwargs)

    monkeypatch.setattr(st, "fit", fit)


def _state_unchanged(m):
    m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _frame_altered(m):
    rows = train.row_renderer

    def altered(*args, **kwargs):
        render = rows(*args, **kwargs)
        return lambda r0, n: _add_to_top_rows(render(r0, n).clone())

    m.setattr(train, "row_renderer", altered)


def _half_the_loss(m):
    whole = train.band_loss_and_grads
    m.setattr(train, "band_loss_and_grads",
              lambda mesh, render, params, target: whole(mesh, render, params,
                                                         target[: target.shape[0] // 2]))


def test_a_sound_run_is_correct():
    assert _run("sphere_repeat_1080p.frames_orbit")["correct"] is True
    assert _run(FIT)["correct"] is True


@pytest.mark.parametrize("change", [_add_to_top_rows, _drop_lower_half],
                         ids=["answer_altered", "half_left_out"])
def test_a_broken_frame_fails(monkeypatch, change):
    monkeypatch.setattr(st.RayMarcher, "render", _broken_frames(change))
    line = _run("sphere_repeat_1080p.frames_orbit")
    assert line["correct"] is False and line["failed"] > 0


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    _state_unchanged(monkeypatch)
    line = _run(FIT)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_frame_left_out_of_the_loss_fails(monkeypatch):
    _half_the_loss(monkeypatch)
    assert _run(FIT)["correct"] is False


def test_a_frame_altered_inside_the_fit_fails(monkeypatch):
    _frame_altered(monkeypatch)
    assert _run(FIT)["correct"] is False


@pytest.mark.parametrize("fault", [_state_unchanged, _frame_altered, _half_the_loss],
                         ids=["state_unchanged", "frame_altered", "half_the_loss"])
def test_a_fault_in_the_window_call_alone_fails(monkeypatch, fault):
    """The set-up's steps are sound and the window's ``fit`` call is broken:
    the check follows the window's first step and judges its last."""
    _in_the_window_only(monkeypatch, fault)
    line = _run(FIT)
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("name", ["sphere_repeat_1080p.frames_orbit",
                                  "union_grid_4_1080p.fit_colours", FIT])
def test_the_control_fails_the_limits(name):
    cell = _cell(name)
    readings = spec.loop(cell.traffic["loop"]).control_readings(cell, SEED, "cpu")
    numbers = {k: v for k, v in readings["control"].items() if k in cell.limits}
    assert not all(c.ok for c in check.judge(numbers, cell.limits))
