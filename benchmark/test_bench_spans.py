"""The per-layer readers of the program's spans and counters
(``harness/program_spans.py`` and the ``metrics/`` files that call it), fed
records built by hand: the window is the last ``count`` top-level spans, the
warm call's before it is left out, a ring that dropped a record of the
window gives None, and so does a program without spans or counters."""

from __future__ import annotations

import pytest

from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.sdf import compile as sc
from sdfkit_tpu_torch.utils import spans

from benchmark.harness import program_spans, spec

MS = 1_000_000
FRAME_READERS = {"wrappers.view_host_ms.frame": "sdf.render.view",
                 "wrappers.params_host_ms.frame": "sdf.render.params",
                 "wrappers.launch_host_ms.frame": "sdf.render.launch"}
FIT_READERS = {"fit.grads_host_ms": "sdf.fit.grads", "fit.optimizer_host_ms": "sdf.fit.optimizer",
               "fit.wait_ms": "sdf.fit.sync"}
CHILDREN = {"sdf.frame": ("sdf.render.view", "sdf.render.params", "sdf.render.launch"),
            "sdf.fit.step": ("sdf.fit.grads", "sdf.fit.grads", "sdf.fit.optimizer",
                             "sdf.fit.sync")}


def _requests(top: str, n: int, t0: int, ms_each: dict, first_id: int = 1) -> list:
    """``n`` top-level spans named ``top`` from ``t0`` ns, 10 ms apart, each
    with its children of ``ms_each[name]`` ms, in the order the spans close."""
    recs, i = [], first_id
    for k in range(n):
        root, start = i, t0 + k * 10 * MS
        i += 1
        edge = start
        for name in CHILDREN[top]:
            d = int(ms_each[name] * MS)
            recs.append(spans.Record(i, name, root, root, 7, edge, edge + d))
            i, edge = i + 1, edge + d
        recs.append(spans.Record(root, top, root, None, 7, start, start + 9 * MS))
    return recs


@pytest.fixture
def ring(monkeypatch):
    """Put hand-built records in the program's ring."""

    def put(recs, dropped=0):
        monkeypatch.setattr(spans, "records", lambda: list(recs))
        monkeypatch.setattr(spans, "DROPPED", dropped)

    return put


def test_frame_readers_read_the_windows_frames_and_not_the_warm_one(ring):
    warm = _requests("sdf.frame", 1, 0, {"sdf.render.view": 5, "sdf.render.params": 5,
                                         "sdf.render.launch": 5})
    window = _requests("sdf.frame", 3, 100 * MS, {"sdf.render.view": 0.5,
                                                  "sdf.render.params": 2.0,
                                                  "sdf.render.launch": 1.25}, first_id=100)
    ring(warm + window)
    ctx = {"loop": "frames", "count": 3}
    got = {m: spec.metric_reader(m)(ctx) for m in FRAME_READERS}
    assert got == pytest.approx({"wrappers.view_host_ms.frame": 0.5,
                                 "wrappers.params_host_ms.frame": 2.0,
                                 "wrappers.launch_host_ms.frame": 1.25})
    assert spec.metric_reader("wrappers.view_host_ms.frame")({"loop": "fit", "count": 3}) is None
    # More frames asked for than the ring holds: nothing to read.
    assert spec.metric_reader("wrappers.view_host_ms.frame")({"loop": "frames",
                                                              "count": 5}) is None


@pytest.mark.parametrize("group", ["fit", "fit_small"])
def test_fit_readers_read_the_windows_steps_and_not_the_warm_one(ring, group):
    each = {"sdf.fit.grads": 0.25, "sdf.fit.optimizer": 1.5, "sdf.fit.sync": 4.0}
    warm = _requests("sdf.fit.step", 1, 0, {n: 3.0 for n in each})
    window = _requests("sdf.fit.step", 4, 50 * MS, each, first_id=200)
    ring(warm + window)
    ctx = {"loop": "fit", "count": 4}
    got = {m: spec.metric_reader(f"{m}.{group}")(ctx) for m in FIT_READERS}
    # Two grads spans a step: the zeroing and the gather.
    assert got == pytest.approx({"fit.grads_host_ms": 0.5, "fit.optimizer_host_ms": 1.5,
                                 "fit.wait_ms": 4.0})
    assert spec.metric_reader(f"fit.wait_ms.{group}")({"loop": "frames", "count": 4}) is None


def test_a_ring_that_dropped_a_record_of_the_window_gives_none(ring):
    each = {"sdf.fit.grads": 0.25, "sdf.fit.optimizer": 1.5, "sdf.fit.sync": 4.0}
    window = _requests("sdf.fit.step", 3, 50 * MS, each)
    ctx = {"loop": "fit", "count": 3}
    read = spec.metric_reader("fit.wait_ms.fit")
    ring(window[1:], dropped=1)  # the first step's first child pushed out
    assert read(ctx) is None
    warm = _requests("sdf.fit.step", 2, 0, each, first_id=500)
    ring(warm[3:] + window, dropped=3)  # only the warm-up's records pushed out
    assert read(ctx) == pytest.approx(4.0)


def test_a_program_without_spans_or_counters_gives_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_spans", lambda: None)
    for m in FRAME_READERS:
        assert spec.metric_reader(m)({"loop": "frames", "count": 2}) is None
    for m in FIT_READERS:
        assert spec.metric_reader(f"{m}.fit")({"loop": "fit", "count": 2}) is None
    monkeypatch.delattr(sc, "TRACE_SECONDS")
    monkeypatch.delattr(build, "LOAD_SECONDS")
    assert spec.metric_reader("setup.compile_s")({}) is None
    assert spec.metric_reader("setup.libraries_s")({}) is None


def test_the_setup_readers_read_the_programs_counters(monkeypatch):
    monkeypatch.setattr(sc, "TRACE_SECONDS", 0.375)
    monkeypatch.setattr(build, "LOAD_SECONDS", 2.5)
    assert spec.metric_reader("setup.compile_s")({"loop": "fit"}) == 0.375
    assert spec.metric_reader("setup.libraries_s")({"loop": "frames"}) == 2.5
