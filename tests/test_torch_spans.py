"""The port's host spans (``utils/spans.py``) and the counters beside them.

Off, a span is one shared no-op that records nothing; on (``enable()`` or a
recording ``torch.profiler``) it keeps a record with its parent on the same
thread and the top-level span of the process as its root, and lies on the
profiler's timeline as a ``user_annotation``. The fit loop, the frame's
wrappers and the render's backward open the spans the benchmark's readers
read; the scene compiler and the library loads count their misses.
"""

import itertools
import json
import shutil
import threading
import time
import tracemalloc

import pytest
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render import raymarch
from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.sdf import compile as sc
from sdfkit_tpu_torch.utils import spans
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

FIT_PHASES = ("sdf.fit.forward", "sdf.fit.backward", "sdf.fit.grads", "sdf.fit.optimizer",
              "sdf.fit.sync")


@pytest.fixture(autouse=True)
def fresh_spans():
    """Each test starts with spans off and an empty ring, and leaves them so."""
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_a_span_is_the_shared_noop_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an off span reached the profiler or the clock")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    monkeypatch.setattr(spans.time, "perf_counter_ns", refuse)
    assert spans.span("sdf.a") is spans.span("sdf.b", top=True) is spans._OFF
    with spans.span("sdf.a") as inside:
        assert inside is None

    def peak(enter):
        """The most memory held at once over 1,000 nested spans, above the start."""
        times = itertools.repeat(None, 1000)
        tracemalloc.start()
        try:
            with enter("sdf.warm"):
                pass
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            for _ in times:
                with enter("sdf.fit.step", top=True):
                    with enter("sdf.fit.grads"):
                        pass
            return tracemalloc.get_traced_memory()[1] - before
        finally:
            tracemalloc.stop()

    # What the with statement itself holds for a moment, with the no-op at hand:
    # span() adds nothing to it.
    assert peak(spans.span) <= peak(lambda name, top=False: spans._OFF)
    assert spans.records() == [] and spans.DROPPED == 0


def test_enabled_spans_nest_by_parent_and_share_the_root():
    spans.enable()
    with spans.span("sdf.fit.step", top=True):
        with spans.span("sdf.fit.forward"):
            with spans.span("sdf.render.params"):
                pass
        with spans.span("sdf.fit.sync"):
            pass
    with spans.span("sdf.compile"):  # outside any top-level span
        pass
    got = _by_name(spans.records())
    step, = got["sdf.fit.step"]
    fwd, = got["sdf.fit.forward"]
    params, = got["sdf.render.params"]
    sync, = got["sdf.fit.sync"]
    lone, = got["sdf.compile"]
    assert step.root == step.id and step.parent is None
    assert fwd.parent == step.id and params.parent == fwd.id and sync.parent == step.id
    assert {r.root for r in (fwd, params, sync)} == {step.id}
    assert lone.root is None and lone.parent is None
    assert step.t0_ns <= fwd.t0_ns <= params.t0_ns <= params.t1_ns <= fwd.t1_ns <= step.t1_ns
    assert [r.name for r in spans.records()] == ["sdf.render.params", "sdf.fit.forward",
                                                 "sdf.fit.sync", "sdf.fit.step", "sdf.compile"]


def test_a_span_on_another_thread_carries_the_open_steps_root():
    spans.enable()
    done = threading.Event()

    def device_thread():
        with spans.span("sdf.render.backward"):
            pass
        done.set()

    with spans.span("sdf.fit.step", top=True):
        with spans.span("sdf.fit.backward"):
            t = threading.Thread(target=device_thread)
            t.start()
            t.join(timeout=30)
    assert done.is_set() and not t.is_alive()
    got = _by_name(spans.records())
    step, = got["sdf.fit.step"]
    bwd, = got["sdf.render.backward"]
    assert bwd.root == step.id and bwd.parent is None and bwd.thread != step.thread
    # Its time is not the main thread's: sdf.fit.backward's self time keeps it.
    s = spans.summary([step.id])
    assert s["sdf.fit.backward"]["self_ms"] == s["sdf.fit.backward"]["total_ms"]


def test_summary_self_time_against_hand_built_intervals():
    R = spans.Record
    ms = 1_000_000
    recs = [
        R(2, "a", 1, 1, 7, 1 * ms, 4 * ms),
        R(3, "b", 1, 1, 7, 5 * ms, 6 * ms),
        R(4, "c", 1, 3, 7, 5 * ms, 5 * ms + ms // 2),
        R(5, "d", 1, 1, 9, 0, 9 * ms),  # another thread: not the step's child in time
        R(1, "step", 1, None, 7, 0, 10 * ms),
        R(6, "a", 8, 8, 7, 20 * ms, 21 * ms),
        R(8, "step", 8, None, 7, 20 * ms, 22 * ms),
    ]
    s = spans.summary(recs=recs)
    assert s["step"] == {"count": 2, "total_ms": 12.0, "self_ms": 6.0 + 1.0}
    assert s["a"] == {"count": 2, "total_ms": 4.0, "self_ms": 4.0}
    assert s["b"] == {"count": 1, "total_ms": 1.0, "self_ms": 0.5}
    assert s["d"]["self_ms"] == 9.0
    first = spans.summary([1], recs)
    assert set(first) == {"step", "a", "b", "c", "d"} and first["a"]["count"] == 1
    assert first["step"]["self_ms"] == 6.0


def test_a_full_ring_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "RING", 4)
    monkeypatch.setattr(spans, "_records", spans.collections.deque(maxlen=4))
    spans.enable()
    for i in range(6):
        with spans.span(f"s{i}"):
            pass
    assert [r.name for r in spans.records()] == ["s2", "s3", "s4", "s5"]
    assert spans.DROPPED == 2
    spans.clear()
    assert spans.records() == [] and spans.DROPPED == 0


def test_under_a_cpu_profiler_the_spans_are_user_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("sdf.frame", top=True):
            with spans.span("sdf.render.view"):
                x = x + 1
            with spans.span("sdf.render.launch"):
                x = x * 2
    assert spans.span("sdf.frame") is spans._OFF  # off again with the profiler
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith("sdf.")}
    assert set(ann) == {"sdf.frame", "sdf.render.view", "sdf.render.launch"}
    frame = ann["sdf.frame"]
    for child in ("sdf.render.view", "sdf.render.launch"):
        c = ann[child]
        assert frame["ts"] <= c["ts"] and c["ts"] + c["dur"] <= frame["ts"] + frame["dur"]
        assert (c["pid"], c["tid"]) == (frame["pid"], frame["tid"])
    assert ann["sdf.render.view"]["ts"] + ann["sdf.render.view"]["dur"] <= \
        ann["sdf.render.launch"]["ts"]
    got = _by_name(spans.records())  # and in the ring, under the profiler alone
    assert got["sdf.render.view"][0].parent == got["sdf.frame"][0].id


def _fit_roots(recs, steps):
    got = _by_name(recs)
    tops = got["sdf.fit.step"]
    assert len(tops) == steps and all(r.root == r.id for r in tops)
    for top in tops:
        names = [r.name for r in recs if r.root == top.id and r.id != top.id]
        for phase in FIT_PHASES:
            assert phase in names, (phase, names)
        assert names.count("sdf.fit.grads") == 2  # the zeroing, then the gather
    return got, tops


def test_fit_opens_a_step_span_with_its_phases():
    scene = st.sphere(1.0)
    target = torch.full((8, 12, 3), 0.5)
    spans.enable()
    seen = []
    st.fit(scene, target, steps=3, backend="torch", progress=lambda s, l: seen.append(s))
    recs = spans.records()
    got, tops = _fit_roots(recs, 3)
    setup, = got["sdf.fit.setup"]
    assert setup.root is None and setup.t1_ns <= tops[0].t0_ns
    assert len(got["sdf.fit.progress"]) == 3 and seen == [0, 1, 2]
    for top in tops:
        kids = {r.name: r for r in recs if r.parent == top.id}
        assert kids["sdf.fit.forward"].t1_ns <= kids["sdf.fit.backward"].t0_ns
        assert kids["sdf.fit.backward"].t1_ns <= kids["sdf.fit.optimizer"].t0_ns
        assert kids["sdf.fit.optimizer"].t1_ns <= kids["sdf.fit.sync"].t0_ns


def test_fit_checkpoints_inside_their_step(tmp_path):
    spans.enable()
    st.fit(st.sphere(1.0), torch.full((6, 8, 3), 0.5), steps=2, backend="torch",
           checkpoint_dir=tmp_path, checkpoint_every=1)
    got = _by_name(spans.records())
    tops = {r.id for r in got["sdf.fit.step"]}
    assert len(got["sdf.fit.checkpoint"]) == 2
    assert {r.parent for r in got["sdf.fit.checkpoint"]} == tops


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("spans_host"))


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The kernels' wrappers on CPU tensors, with the g++ loops in place of
    the launches, and the scene taken for a card's so that ``auto`` picks
    them."""
    patch_kernels(monkeypatch, host_libs)
    monkeypatch.setattr(raymarch, "_on_cuda", lambda expr: True)


def test_a_frame_splits_into_view_params_and_launch(on_host):
    scene = st.sphere(1.0) | st.box(0.5).translate(1.0, 0.0, 0.0)
    marcher = st.RayMarcher(16, 10, scene)
    assert marcher.backend == "kernel"
    marcher.render()  # the compiler's miss, if any, before the counted frames
    spans.enable()
    with torch.no_grad():
        for _ in range(2):
            marcher.render()
        marcher.render_depth()
    recs = spans.records()
    got = _by_name(recs)
    frames = got["sdf.frame"]
    assert len(frames) == 3 and all(f.root == f.id and f.parent is None for f in frames)
    for f in frames:
        kids = sorted((r for r in recs if r.parent == f.id), key=lambda r: r.t0_ns)
        assert [k.name for k in kids] == ["sdf.render.params", "sdf.render.view",
                                          "sdf.render.launch"]
        assert all(k.root == f.id for k in kids)
    s = spans.summary([f.id for f in frames])
    assert s["sdf.frame"]["total_ms"] >= sum(
        s[n]["total_ms"] for n in ("sdf.render.view", "sdf.render.params", "sdf.render.launch"))


def test_the_renders_backward_carries_its_steps_root(on_host):
    scene = st.sphere(1.0).translate(0.1, 0.0, 0.0)
    target = torch.full((6, 8, 3), 0.5)
    spans.enable()
    st.fit(scene, target, steps=2, backend="kernel")
    recs = spans.records()
    got, tops = _fit_roots(recs, 2)
    bwd = got["sdf.render.backward"]
    assert sorted(r.root for r in bwd) == sorted(t.id for t in tops)
    launches = got["sdf.render.launch"]
    assert sorted(r.root for r in launches) == sorted(t.id for t in tops)
    views = got["sdf.render.view"]  # the band's ivp and cam concatenated
    assert sorted(r.root for r in views) == sorted(t.id for t in tops)


def test_the_compiler_counts_its_misses_and_not_its_hits(monkeypatch):
    monkeypatch.setattr(sc, "_PROGRAMS", {})
    scene = st.sphere(0.7).translate(0.2, 0.0, 0.0)
    traces, seconds = sc.TRACES, sc.TRACE_SECONDS
    spans.enable()
    first = sc.compile_scene(scene)
    assert sc.TRACES == traces + 1 and sc.TRACE_SECONDS > seconds
    seconds = sc.TRACE_SECONDS
    again = sc.compile_scene(st.sphere(0.3).translate(0.0, 0.5, 0.0))  # same structure
    assert again is first and sc.TRACES == traces + 1 and sc.TRACE_SECONDS == seconds
    assert [r.name for r in spans.records()] == ["sdf.compile"]


def test_library_loads_count_their_misses_and_not_their_hits(monkeypatch):
    monkeypatch.setattr(build, "_LIBS", {})
    made = []

    def fake_load(program, fam, family, name):
        time.sleep(0.001)
        made.append(family)
        return object()

    monkeypatch.setattr(build, "_load", fake_load)
    program = sc.compile_scene(st.sphere(1.0))
    loads, seconds = build.LOADS, build.LOAD_SECONDS
    spans.enable()
    lib = build.load(program)
    assert build.load(program) is lib and made == ["fwd"]
    build.load_bwd(program)
    assert made == ["fwd", "bwd"] and build.LOADS == loads + 2
    assert build.LOAD_SECONDS >= seconds + 0.002
    assert [r.name for r in spans.records()] == ["sdf.build", "sdf.build"]
