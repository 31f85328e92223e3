"""The scene compiler's memo of each tree's program and leaves
(``sdf/compile.py`` ``_scene``), read by the kernel wrappers on every frame and
fit step.

A repeated call on an unchanged tree reads the memo; an edit of any scene's
structure (``sdf/expr.py`` ``EDITS``) sends the next call back to the tree's
structure and leaves. Every case is held bit for bit: to a freshly built
scene after a structural edit, to the parameters' current values after an
edit of values, and to the plain concatenation of the leaves that the flat
buffer replaces. The frames and gradients go through the kernel wrappers
with the g++ builds of the kernels' per-ray code in place of the launches
(``tests/torch_host.py``).
"""

import shutil

import numpy as np
import pytest
import torch
from torch import nn

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render import raymarch
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.sdf import compile as sc
from sdfkit_tpu_torch.sdf import expr as sdf_expr
from sdfkit_tpu_torch.sdf.expr import Repeat
from sdfkit_tpu_torch.utils.camera import default_view
from sdfkit_tpu_torch.utils.v3 import V3
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

CFG = RenderConfig(width=16, height=12)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("program_memo_host"))


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The kernels' wrappers on CPU tensors, the scene taken for a card's."""
    calls = patch_kernels(monkeypatch, host_libs)
    monkeypatch.setattr(raymarch, "_on_cuda", lambda expr: True)
    return calls


def _param(v):
    return nn.Parameter(torch.tensor(v, dtype=torch.float32))


def _cell_colour(index, p, c, d):
    return V3(c.x * 0.5 + 0.1 * index.x, c.y, c.z)


def _scene(a=None, sizes=(1.5, 1.5), axes="xz", color_fn=None):
    """A translated sphere beside a repeated box: every kind of field the
    edits below touch (a child, parameters, a scalar list, statics)."""
    if a is None:
        a = st.sphere(0.5, color=(0.9, 0.3, 0.2)).translate(-0.4, 0.1, 0.0)
    box = st.box(0.25, color=(0.2, 0.6, 0.9))
    return a | Repeat(box, tuple(sizes), axes=axes, color_fn=color_fn)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _plain_flat(expr):
    """The flat buffer as the wrappers built it before the memo: a walk of
    the tree and a reshape of every leaf."""
    return torch.cat([p.reshape(-1) for p in st.leaves(expr)])


def _frame_and_grads(expr):
    """The kernels' frame of ``expr`` and every leaf's gradient of a fixed
    weighting of it."""
    for p in st.leaves(expr):
        p.grad = None
    img = rk.render_image_kernel(expr, default_view("cpu"), CFG)
    weights = torch.linspace(-1.0, 1.0, img.numel()).reshape(img.shape)
    (img * weights).sum().backward()
    return img.detach(), [p.grad for p in st.leaves(expr)]


def _assert_same(got, want):
    (img_a, grads_a), (img_b, grads_b) = got, want
    assert torch.equal(_bits(img_a), _bits(img_b))
    assert len(grads_a) == len(grads_b)
    for a, b in zip(grads_a, grads_b):
        assert a is not None and b is not None
        assert torch.equal(_bits(a), _bits(b))


# Each structural edit the DSL allows: what it needs, made before the memo
# is read (building a node is itself an edit), the edit, and the scene it
# makes, built afresh.
EDITS = {
    "a child replaced": (
        lambda s: st.box(0.3, color=(0.5, 0.5, 0.1)),
        lambda s, box: setattr(s, "a", box),
        lambda: _scene(a=st.box(0.3, color=(0.5, 0.5, 0.1)))),
    "a child added with add_module": (
        lambda s: st.sphere(0.6, color=(0.1, 0.8, 0.3)).translate(0.2, 0.0, 0.1),
        lambda s, child: s.add_module("a", child),
        lambda: _scene(a=st.sphere(0.6, color=(0.1, 0.8, 0.3)).translate(0.2, 0.0, 0.1))),
    "a parameter object replaced": (
        lambda s: _param(0.6),
        lambda s, radius: setattr(s.a.child, "radius", radius),
        lambda: _scene(a=st.sphere(0.6, color=(0.9, 0.3, 0.2)).translate(-0.4, 0.1, 0.0))),
    "a parameter registered": (
        lambda s: _param([0.3, 0.0, -0.2]),
        lambda s, offset: s.a.register_parameter("offset", offset),
        lambda: _scene(a=st.sphere(0.5, color=(0.9, 0.3, 0.2)).translate(0.3, 0.0, -0.2))),
    "color_fn set": (
        lambda s: None,
        lambda s, _: setattr(s.b, "color_fn", _cell_colour),
        lambda: _scene(color_fn=_cell_colour)),
    "a scalar replaced in its list": (
        lambda s: _param(2.0),
        lambda s, size: s.b.sizes.__setitem__(0, size),
        lambda: _scene(sizes=(2.0, 1.5))),
    "a scalar appended and the axes widened": (
        lambda s: _param(1.25),
        lambda s, size: (s.b.sizes.append(size), setattr(s.b, "axes", "xyz")),
        lambda: _scene(sizes=(1.5, 1.5, 1.25), axes="xyz")),
    "a plain ParameterList set, then edited in place": (
        lambda s: (setattr(s.b, "sizes", nn.ParameterList([_param(1.5), _param(1.5)])),
                   _param(0.75))[1],
        lambda s, size: s.b.sizes.__setitem__(1, size),
        lambda: _scene(sizes=(1.5, 0.75))),
}


@pytest.mark.parametrize("name", list(EDITS))
def test_a_structural_edit_reaches_the_program_of_a_fresh_scene(on_host, name):
    prepare, edit, fresh = EDITS[name]
    scene = _scene()
    made = prepare(scene)
    _frame_and_grads(scene)
    before = sc.compile_scene(scene)
    assert sc.compile_scene(scene) is before  # a memo hit
    edits = sdf_expr.EDITS
    edit(scene, made)
    assert sdf_expr.EDITS > edits
    want_scene = fresh()
    assert sc.compile_scene(scene) is sc.compile_scene(want_scene)
    assert torch.equal(_bits(sc.flat_params(scene)), _bits(_plain_flat(want_scene)))
    _assert_same(_frame_and_grads(scene), _frame_and_grads(want_scene))


def test_edits_of_values_keep_the_memo_and_show_their_values():
    scene = _scene()
    prog = sc.compile_scene(scene)
    memo = sc._SCENES[scene]
    traces, edits = sc.TRACES, sdf_expr.EDITS
    rng = np.random.default_rng(3)
    arrays = [rng.uniform(0.2, 0.8, tuple(p.shape)).astype(np.float32) for p in st.leaves(scene)]
    st.load_leaves(scene, arrays)
    assert torch.equal(sc.flat_params(scene), torch.from_numpy(np.concatenate(
        [a.reshape(-1) for a in arrays])))
    with torch.no_grad():
        for p in st.leaves(scene):
            p.data.mul_(1.5)  # as an optimizer's step does, in place
    st.leaves(scene)[0].data[()] = -0.25
    assert torch.equal(_bits(sc.flat_params(scene)), _bits(_plain_flat(scene)))
    assert float(sc.flat_params(scene)[0].detach()) == -0.25
    assert sc.compile_scene(scene) is prog and sc._SCENES[scene] is memo
    assert (sc.TRACES, sdf_expr.EDITS) == (traces, edits)


def test_a_memo_hit_returns_the_program_and_the_plain_concatenation():
    scene = _scene(color_fn=_cell_colour)
    prog = sc.compile_scene(scene)
    traces = sc.TRACES
    for _ in range(3):
        assert sc.compile_scene(scene) is prog
        flat = sc.flat_params(scene)
        assert torch.equal(_bits(flat), _bits(_plain_flat(scene)))
        assert flat.is_contiguous() and flat.dtype == torch.float32
    assert sc.TRACES == traces
    # One leaf: a copy, as the plain concatenation is, never a view of the leaf.
    lone = st.solid(lambda p: p.length() - 1.0)
    assert len(st.leaves(lone)) == 1
    flat = sc.flat_params(lone)
    assert torch.equal(flat, _plain_flat(lone))
    assert flat.data_ptr() != st.leaves(lone)[0].data_ptr()


def test_the_leaves_gradients_are_the_plain_concatenations():
    scene = _scene(color_fn=_cell_colour)
    weights = torch.linspace(-2.0, 2.0, sc.compile_scene(scene).n_params)
    weights[::3] = -0.0  # gradients of -0.0, whose sign a sum onto zeros would lose

    def grads(flat):
        for p in st.leaves(scene):
            p.grad = None
        (flat * weights).sum().backward()
        return [p.grad.clone() for p in st.leaves(scene)]

    for _ in range(2):  # the second a memo hit, after an in-place step
        for a, b in zip(grads(sc.flat_params(scene)), grads(_plain_flat(scene))):
            assert torch.equal(_bits(a), _bits(b))
        with torch.no_grad():
            for p in st.leaves(scene):
                p.add_(0.01)


def test_a_move_reads_the_parameters_where_they_went():
    scene = _scene()
    sc.flat_params(scene)
    scene.to("meta")
    assert sc.flat_params(scene).device.type == "meta"

    scene = _scene()
    sc.flat_params(scene)
    scene.double()  # keeps the Parameter objects, their data replaced
    flat = sc.flat_params(scene)
    assert flat.dtype == torch.float64 and torch.equal(flat, _plain_flat(scene))

    scene = _scene()
    old = st.leaves(scene)
    sc.flat_params(scene)
    overwrite = torch.__future__.get_overwrite_module_params_on_conversion()
    torch.__future__.set_overwrite_module_params_on_conversion(True)
    try:
        scene.double()  # new Parameter objects in the nodes
    finally:
        torch.__future__.set_overwrite_module_params_on_conversion(overwrite)
    new = st.leaves(scene)
    assert all(a is not b for a, b in zip(old, new))
    flat = sc.flat_params(scene)
    assert flat.dtype == torch.float64 and torch.equal(flat, _plain_flat(scene))
    flat.sum().backward()
    assert all(p.grad is not None for p in new) and all(p.grad is None for p in old)


def test_the_compiler_traces_once_per_new_structure(monkeypatch):
    monkeypatch.setattr(sc, "_PROGRAMS", {})
    traces = sc.TRACES
    scene = _scene()
    first = sc.compile_scene(scene)
    assert sc.compile_scene(scene) is first and sc.TRACES == traces + 1
    twin = _scene(sizes=(0.9, 1.1))  # a second tree of the same structure
    assert sc.compile_scene(twin) is first and sc.TRACES == traces + 1
    scene.b.color_fn = _cell_colour
    second = sc.compile_scene(scene)
    assert second is not first and sc.TRACES == traces + 2
    assert sc.compile_scene(scene) is second and sc.compile_scene(twin) is first
    assert sc.TRACES == traces + 2
    # Another program table in place of the old: the memo's program is not in it.
    monkeypatch.setattr(sc, "_PROGRAMS", {})
    third = sc.compile_scene(scene)
    assert third is not second and sc.TRACES == traces + 3


def test_two_renders_of_one_scene_are_bit_for_bit(on_host):
    scene = _scene(color_fn=_cell_colour)
    first = _frame_and_grads(scene)
    assert sc._SCENES[scene][2] is sc.compile_scene(scene)
    second = _frame_and_grads(scene)
    _assert_same(second, first)
    assert (on_host["fwd"], on_host["bwd"]) == (2, 2)


def test_a_fit_on_memo_hits_is_the_walking_wrappers_fit(on_host, monkeypatch):
    """``fit`` through the memo against ``fit`` through wrappers that walk the
    tree and reshape every leaf on every step, as they did before it."""
    target = torch.linspace(0.0, 1.0, CFG.height * CFG.width * 3).reshape(
        CFG.height, CFG.width, 3)

    def run():
        scene = _scene(color_fn=_cell_colour)
        res = st.fit(scene, target, steps=3, backend="kernel", learning_rate=5e-2)
        return res.losses, [p.detach().clone() for p in st.leaves(res.sdf)]

    losses, fitted = run()
    monkeypatch.setattr(rk, "compile_scene", sc._lookup)
    monkeypatch.setattr(rk, "flat_params", _plain_flat)
    plain_losses, plain_fitted = run()
    assert losses == plain_losses
    for a, b in zip(fitted, plain_fitted):
        assert torch.equal(_bits(a), _bits(b))
