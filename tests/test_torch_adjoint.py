"""The scene compiler's adjoint against torch autograd, ``jax.vjp`` and g++.

For every scene of ``torch_parity.NAMES``: 1024 seeded points and seeded
cotangents for (r, g, b, distance) go through

* ``run_vjp``, the adjoint as torch ops;
* torch autograd of the port's ``expr.eval``;
* ``jax.vjp`` of the JAX package's ``eval`` (eager, op by op, on the CPU);
* the emitted ``sdf_eval_vjp`` and ``sdf_dist_unit``, compiled with g++.

The distance's adjoint is emitted in unit form (``sdf_dist_unit``: the
gradient for a cotangent of one, which the kernels scale by a seed); its torch
counterpart is ``run_unit``. Both are held to ``run_vjp`` with a seeded
cotangent at rtol 1e-6 plus 1e-6 of the point's largest entry: a vjp is
linear in its seed, and scaling after the sweep moves one rounding per
product, which an entry that sums products of opposite sign (a rotation's
angle) keeps at the products' size.

The points' cotangents are per point and are held at rtol 1e-5 / atol 1e-6.
The parameters' cotangents are sums over the 1024 points, which each program
takes in its own order in float32 (the emitted code is called point by point
and summed in float64 here): they are held at rtol 1e-5 with an absolute term
of 1e-6 times the sum of the cotangents' magnitudes, the scale of a float32
sum's rounding. Points where the two packages already disagree on the forward
value (another side of a ``min``/``max`` tie or of a cell boundary, an ulp of
``sin``) get zero cotangents in the JAX comparison.
"""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.utils.v3 import V3 as JV
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params, run_unit, run_vjp
from sdfkit_tpu_torch.utils.v3 import V3
from test_torch_kernel_host import SHIM, _gxx

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

N = 1024
POINTS = (np.random.default_rng(0).random((N, 3)) * 6 - 3).astype(np.float32)
COTANGENTS = np.random.default_rng(1).standard_normal((4, N)).astype(np.float32)
SUM_ATOL = 1e-6 * float(np.abs(COTANGENTS).sum())


def flat(arrays):
    return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays])


def adjoint(texpr, cot, want_color=True):
    """(points' cotangent (N, 3), parameters' cotangent) from run_vjp."""
    pts = torch.from_numpy(POINTS)
    cts = tuple(torch.from_numpy(c) for c in cot) if want_color else torch.from_numpy(cot[3])
    gp, gparams = run_vjp(compile_scene(texpr), V3.from_array(pts), flat_params(texpr).detach(),
                          cts, want_color=want_color)
    return np.stack([gp.x.numpy(), gp.y.numpy(), gp.z.numpy()], axis=-1), gparams.numpy()


def autograd(texpr, cot, want_color=True):
    pts = torch.from_numpy(POINTS).clone().requires_grad_()
    color, dist = texpr.eval(V3.from_array(pts))
    outs = (color.x, color.y, color.z, dist) if want_color else (dist,)
    cts = cot if want_color else cot[3:]
    total = sum((torch.broadcast_to(torch.as_tensor(o), dist.shape) * torch.from_numpy(c)).sum()
                for o, c in zip(outs, cts))
    for p in st.leaves(texpr):
        p.grad = None
    total.backward()
    return pts.grad.numpy(), flat(tp.leaf_grads(texpr))


@pytest.mark.parametrize("name", tp.NAMES)
def test_run_vjp_matches_torch_autograd(name):
    _, texpr = tp.build(name, perturb_seed=5)
    gp, gparams = adjoint(texpr, COTANGENTS)
    ref_gp, ref_gparams = autograd(texpr, COTANGENTS)
    assert np.isfinite(gp).all() and np.isfinite(gparams).all()
    np.testing.assert_allclose(gp, ref_gp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gparams, ref_gparams, rtol=1e-5, atol=SUM_ATOL)


@pytest.mark.parametrize("name", ["union", "repeat_xy", "sphere_repeat", "box"])
def test_run_vjp_distance_only_matches_torch_autograd(name):
    _, texpr = tp.build(name, perturb_seed=5)
    gp, gparams = adjoint(texpr, COTANGENTS, want_color=False)
    ref_gp, ref_gparams = autograd(texpr, COTANGENTS, want_color=False)
    np.testing.assert_allclose(gp, ref_gp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gparams, ref_gparams, rtol=1e-5, atol=SUM_ATOL)


@pytest.mark.parametrize("name", tp.NAMES)
def test_run_vjp_matches_jax_vjp(name):
    jexpr, texpr = tp.build(name, perturb_seed=5)
    x, y, z = (jnp.asarray(POINTS[:, k]) for k in range(3))

    def jeval(e, x, y, z):
        color, dist = e.eval(JV(x, y, z))
        return tuple(jnp.broadcast_to(c, dist.shape) for c in (color.x, color.y, color.z)) + (dist,)

    outs, vjp = jax.vjp(jeval, jexpr, x, y, z)
    with torch.no_grad():
        color, dist = texpr.eval(V3.from_array(torch.from_numpy(POINTS)))
    same = np.ones(N, bool)
    for jo, to in zip(outs, (color.x, color.y, color.z, dist)):
        to = torch.broadcast_to(torch.as_tensor(to), dist.shape).detach().numpy()
        same &= np.isclose(np.asarray(jo), to, rtol=1e-5, atol=1e-6)
    assert same.mean() > 0.98, f"{(~same).sum()} of {N} points differ in the forward value"
    cot = COTANGENTS * same
    g_expr, gx, gy, gz = vjp(tuple(jnp.asarray(c) for c in cot))
    gp, gparams = adjoint(texpr, cot)
    np.testing.assert_allclose(gp, np.stack([gx, gy, gz], axis=-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gparams, flat(tp.jax_leaf_grads(g_expr)), rtol=1e-5, atol=SUM_ATOL)


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    """name -> (expr, gp, dist, gparams) from the g++ build of every scene's
    emitted adjoints: one translation unit holds each scene in its own
    namespace. Per point, entry 0 is ``sdf_eval_vjp`` with the four seeded
    cotangents and entry 1 ``sdf_dist_unit`` scaled by the distance's
    (``sdf_dist_unit_add`` for the parameters): the point's cotangent (3),
    the distance, and that point's parameter cotangents."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    tmp_path = tmp_path_factory.mktemp("adjoints")
    exprs = [tp.build(name, perturb_seed=5)[1] for name in tp.NAMES]
    parts = [SHIM]
    for i, expr in enumerate(exprs):
        prog = compile_scene(expr)
        parts.append(f"namespace s{i} {{\n{prog.source}\n{prog.adjoint_source}\n"
                     f"const int n_slots = SDF_N_DIST_SLOTS;\n}}\n"
                     f"#undef SDF_N_PARAMS\n#undef SDF_N_DIST_SLOTS\n")
        parts.append(
            f'extern "C" void vjp_{i}(const float* P, const float* pts, const float* cot, int n,\n'
            f"                       int n_params, float* gp, float* dist, float* gP) {{\n"
            f"  for (int k = 0; k < n; ++k) {{\n"
            f"    float* e = gp + 6 * k;\n"
            f"    dist[2 * k] = s{i}::sdf_eval_vjp(pts[3 * k], pts[3 * k + 1], pts[3 * k + 2], P,\n"
            f"        cot[k], cot[n + k], cot[2 * n + k], cot[3 * n + k], e, e + 1, e + 2,\n"
            f"        gP + (long)(2 * k) * n_params);\n"
            f"    float uP[s{i}::n_slots + 1];\n"
            f"    dist[2 * k + 1] = s{i}::sdf_dist_unit(pts[3 * k], pts[3 * k + 1], pts[3 * k + 2], P,\n"
            f"        e + 3, e + 4, e + 5, uP);\n"
            f"    for (int c = 3; c < 6; ++c) e[c] *= cot[3 * n + k];\n"
            f"    s{i}::sdf_dist_unit_add(cot[3 * n + k], uP, gP + (long)(2 * k + 1) * n_params);\n"
            f"  }}\n}}\n"
        )
    src = tmp_path / "all_adjoints.cc"
    src.write_text("".join(parts))
    lib = _gxx(src, tmp_path / "all_adjoints.so")
    results = {}
    for i, (name, expr) in enumerate(zip(tp.NAMES, exprs)):
        fn = getattr(lib, f"vjp_{i}")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        params = flat_params(expr).detach().contiguous()
        n_params = params.numel()
        gp = np.empty((N, 2, 3), np.float32)
        dist = np.empty((N, 2), np.float32)
        gparams = np.zeros((N, 2, n_params), np.float32)
        fn(params.data_ptr(), POINTS.ctypes.data, COTANGENTS.ctypes.data, N, n_params,
           gp.ctypes.data, dist.ctypes.data, gparams.ctypes.data)
        results[name] = (expr, gp, dist, gparams)
    return results


def test_emitted_adjoints_match_run_vjp(emitted):
    """Every node type through the adjoint emitter, seeded and unit form."""
    for name, (expr, gp, dist, gparams) in emitted.items():
        with torch.no_grad():
            ref_dist = expr(torch.from_numpy(POINTS)).numpy()[:, 3]
        for k, want_color in enumerate((True, False)):
            ref_gp, ref_gparams = adjoint(expr, COTANGENTS, want_color=want_color)
            np.testing.assert_allclose(dist[:, k], ref_dist, rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(gp[:, k], ref_gp, rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(gparams[:, k].astype(np.float64).sum(axis=0), ref_gparams,
                                       rtol=1e-5, atol=SUM_ATOL, err_msg=name)


def assert_rows_close(got, want):
    """rtol 1e-6 plus 1e-6 of each row's largest entry (module docstring)."""
    bound = 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max(axis=-1, keepdims=True) + 1e-30
    worst = float((np.abs(got - want) / bound).max())
    assert worst <= 1.0, f"{worst:.3g} times the bound"


def seeded_distance_vjp(texpr):
    """run_vjp of the distance per point: (gp (N, 3), gparams (N, n_params)),
    the parameters' cotangents not summed (one point per call)."""
    program, params = compile_scene(texpr), flat_params(texpr).detach()
    gp, gparams = adjoint(texpr, COTANGENTS, want_color=False)
    rows = np.zeros((N, params.numel()), np.float32)
    pts = torch.from_numpy(POINTS)
    for k in range(0, N, 64):  # every 64th point: one run_vjp call per point is slow
        _, g = run_vjp(program, V3.from_array(pts[k:k + 1]), params,
                       torch.from_numpy(COTANGENTS[3, k:k + 1]), want_color=False)
        rows[k] = g.numpy()
    return gp, gparams, rows


@pytest.mark.parametrize("name", tp.NAMES)
def test_unit_pullback_times_a_seed_is_run_vjp(name):
    """``run_unit`` scaled by the distance's cotangent against ``run_vjp``
    seeded with it: per point for the point's cotangent and (every 64th
    point) the parameters', and summed over the points."""
    _, texpr = tp.build(name, perturb_seed=5)
    u, uparams = run_unit(compile_scene(texpr), V3.from_array(torch.from_numpy(POINTS)),
                          flat_params(texpr).detach())
    seed = COTANGENTS[3]
    gp, gparams, rows = seeded_distance_vjp(texpr)
    got_gp = np.stack([seed * np.broadcast_to(c.numpy(), (N,)) for c in (u.x, u.y, u.z)], -1)
    assert_rows_close(got_gp, gp)
    scaled = uparams.numpy().astype(np.float64) * seed
    assert_rows_close(scaled[:, ::64].T, rows[::64])
    np.testing.assert_allclose(scaled.sum(axis=1), gparams, rtol=1e-5, atol=SUM_ATOL)


@pytest.mark.parametrize("name", tp.NAMES)
def test_emitted_unit_pullback_times_a_seed_is_run_vjp(emitted, name):
    """The g++ build of ``sdf_dist_unit`` / ``sdf_dist_unit_add`` scaled by
    the distance's cotangent against ``run_vjp`` seeded with it."""
    expr, gp, _, gparams = emitted[name]
    ref_gp, ref_gparams, rows = seeded_distance_vjp(expr)
    assert_rows_close(gp[:, 1], ref_gp)
    assert_rows_close(gparams[::64, 1], rows[::64])
    np.testing.assert_allclose(gparams[:, 1].astype(np.float64).sum(axis=0), ref_gparams,
                               rtol=1e-5, atol=SUM_ATOL)


def test_where_selects_the_cotangent():
    """zero_safe_length at the exact zero vector: sqrt'(1) * 0 selected away,
    never sqrt'(0) * 0. Inside the box the adjoint is finite and the bounds
    get the gradient of the interior term alone."""
    box = st.box((1.0, 2.0, 3.0))
    pts = torch.tensor([[0.2, 0.1, -0.3]])
    gp, gparams = run_vjp(compile_scene(box), V3.from_array(pts), flat_params(box).detach(),
                          torch.ones(1), want_color=False)
    assert torch.isfinite(gparams).all()
    np.testing.assert_array_equal(gparams[:3].numpy(), [-1.0, 0.0, 0.0])
    np.testing.assert_array_equal([gp.x.item(), gp.y.item(), gp.z.item()], [1.0, 0.0, 0.0])


def test_min_max_tie_splits_the_cotangent():
    """Two equal spheres: the union's min is a tie everywhere, and each
    radius gets half the cotangent, as torch.minimum and jnp.minimum give."""
    u = st.sphere(1.0) | st.sphere(1.0)
    pts = torch.tensor([[0.5, 0.25, 2.0], [3.0, 0.0, 0.0]])
    _, gparams = run_vjp(compile_scene(u), V3.from_array(pts), flat_params(u).detach(),
                         torch.ones(2), want_color=False)
    np.testing.assert_array_equal(gparams[[0, 4]].numpy(), [-1.0, -1.0])


def test_forward_source_and_hash_do_not_hold_the_adjoint():
    prog = compile_scene(tp.build("sphere_repeat")[1])
    assert "_vjp" not in prog.source and "_unit" not in prog.source
    assert "sdf_dist_unit" in prog.adjoint_source and "sdf_eval_vjp" in prog.adjoint_source
    assert prog.hash != prog.adjoint_hash and len(prog.adjoint_hash) == 16
