"""The scene compiler: the CPU executor of the SSA program against direct
``eval``, the program hash, dead-code removal and unsupported ops.

The executor runs the same torch ops in the same order as ``eval``, so the
comparison is at rtol 1e-6 / atol 1e-7 (in practice bit-exact).
"""

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.ops import UnsupportedOpError
from sdfkit_tpu_torch.sdf import compile as C
from sdfkit_tpu_torch.utils.v3 import V3

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")


def _p(seed=0, n=4096):
    pts = (np.random.default_rng(seed).random((3, n)) * 6 - 3).astype(np.float32)
    return V3(*(torch.from_numpy(c.copy()) for c in pts))


def _full(v, like):
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32), like.shape).detach()


@pytest.mark.parametrize("name", tp.NAMES)
def test_executor_matches_eval(name):
    _, texpr = tp.build(name, perturb_seed=11)
    p = _p()
    prog = C.compile_scene(texpr)
    with torch.no_grad():
        color, dist = texpr.eval(p)
        xc, xd = C.run(prog, p, C.flat_params(texpr))
        _, xd_only = C.run(prog, p, C.flat_params(texpr), want_color=False)
    np.testing.assert_allclose(_full(xd, dist).numpy(), dist.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_full(xd_only, dist).numpy(), dist.numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip((xc.x, xc.y, xc.z), (color.x, color.y, color.z)):
        np.testing.assert_allclose(_full(a, dist).numpy(), _full(b, dist).numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert prog.n_params == sum(p.numel() for p in st.leaves(texpr))


def test_executor_gradients_reach_the_flat_buffer():
    _, texpr = tp.build("smooth_union")
    params = C.flat_params(texpr)
    _, d = C.run(C.compile_scene(texpr), _p(2, 64), params, want_color=False)
    d.sum().backward()
    assert all(p.grad is not None for p in st.leaves(texpr))


def test_parameter_edit_keeps_the_hash():
    _, texpr = tp.build("sphere_repeat")
    h = C.compile_scene(texpr).hash
    src = C.trace(texpr).source
    with torch.no_grad():
        for p in st.leaves(texpr):
            p.mul_(1.37)
    assert C.trace(texpr).hash == h and C.compile_scene(texpr).hash == h
    # The source holds slots, never values.
    assert C.trace(texpr).source == src
    assert "1.125" not in src and "P[" in src


@pytest.mark.parametrize("other", [
    "repeat_xy_checker",  # a different callback
    "repeat_xz",          # different axes
    "repeat_indexed",     # a palette instead of a callback
])
def test_structure_change_changes_the_hash(other):
    _, a = tp.build("repeat_xy")
    _, b = tp.build(other)
    assert C.compile_scene(a).hash != C.compile_scene(b).hash


def test_structure_change_of_flags_and_shapes():
    base = st.box(0.5)
    hashes = {
        C.trace(base).hash,
        C.trace(st.box(0.5).rotate_x(0.3)).hash,
        C.trace(st.box(0.5).rotate_y(0.3)).hash,
        C.trace(st.sphere(0.5).repeat_indexed("x", (1.0,), np.ones((2, 3)))).hash,
        C.trace(st.sphere(0.5).repeat_indexed("x", (1.0,), np.ones((3, 3)))).hash,
    }
    assert len(hashes) == 5


def test_distance_program_drops_colour_code():
    _, texpr = tp.build("repeat_indexed")
    prog = C.compile_scene(texpr)
    ops_of = lambda live: {prog.nodes[i][0] for i in live}  # noqa: E731
    assert "gather" in ops_of(prog.eval_live)
    assert "gather" not in ops_of(prog.dist_live)
    assert len(prog.dist_live) < len(prog.eval_live)
    dist_src = prog.source.split("sdf_eval")[0]
    assert "P[6" not in dist_src  # no palette slot is read by sdf_dist


def test_constant_colour_becomes_a_per_pixel_value():
    s = st.sphere(1.0).repeat_xy(1.0, 1.0, lambda i, p, c, d: V3(0.25, ops.full_like(d, 0.5), c.z))
    prog = C.compile_scene(s)
    assert "*r = 2.500000000e-01f;" in prog.source
    assert "*g = 5.000000000e-01f;" in prog.source
    xc, xd = C.run(prog, _p(3, 16), C.flat_params(s))
    assert float(xc.x) == 0.25 and float(xc.y) == 0.5


@pytest.mark.parametrize("fn,op", [
    (lambda i, p, c, d: V3(torch.tanh(i.x), c.y, c.z), "tanh"),
    (lambda i, p, c, d: V3(np.exp(i.x), c.y, c.z), "exp"),
    (lambda i, p, c, d: V3(ops.tanh(i.x), c.y, c.z), "tanh"),
])
def test_callback_outside_ops_names_the_op(fn, op):
    s = st.sphere(0.5).repeat_xy(1.0, 1.0, fn)
    with pytest.raises((UnsupportedOpError, AttributeError), match=op):
        C.trace(s)


def test_python_control_flow_on_a_value_raises():
    s = st.solid(lambda p: p.x if p.x > 0 else -p.x)
    with pytest.raises(UnsupportedOpError, match="where"):
        C.trace(s)


def test_floor_mod_is_emitted_not_fmodf():
    prog = C.compile_scene(st.sphere(0.5).repeat_x(1.0))
    assert "floorf" in prog.source and "fmodf" not in prog.source
