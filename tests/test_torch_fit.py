"""Differentiable fitting in the port: it tracks the JAX package's ``fit``
step for step, converges to a known target, and resumes from a checkpoint.

Counterpart of ``tests/test_fit.py``; ``fit(mesh=)`` over 2 and 4 ranks is
held to the JAX package's in ``tests/test_torch_distributed.py``. On the CPU ``backend="auto"`` is the plain path, so
the comparison is with the JAX package's ``backend="jnp"``: both run
global-norm clipping at 1.0 and Adam on the mean squared error of a 24x16
frame. Two programs' losses drift apart by float32 rounding through the 40
march steps and the optimizer: rtol 1e-3 / atol 1e-5 on the losses and rtol
1e-3 on the radius, the JAX package's own bound between its two backends.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
from sdfkit_tpu.fit import fit as jax_fit
from sdfkit_tpu_torch.fit import clip_by_global_norm_, fit

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

W, H = 24, 16


def target_image():
    return np.asarray(sk.render(sk.sphere(1.0, color=(0.8, 0.3, 0.2)), W, H))


def start_sdf(m=st):
    return m.sphere(0.7, color=(0.4, 0.4, 0.4))


def test_five_steps_track_the_jax_fit():
    tgt = target_image()
    rj = jax_fit(start_sdf(sk), tgt, steps=5, learning_rate=0.02, backend="jnp")
    rt = fit(start_sdf(), tgt, steps=5, learning_rate=0.02)
    assert rt.losses[-1] < rt.losses[0]
    assert rt.steps_run == 5 and rt.resumed_from is None
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(rt.sdf.radius.item(), float(rj.sdf.radius), rtol=1e-3)
    np.testing.assert_allclose(rt.sdf.rgb.detach().numpy(), np.asarray(rj.sdf.rgb), rtol=1e-3)


def test_loss_descends_and_radius_converges():
    res = fit(start_sdf(), target_image(), steps=150, learning_rate=0.02)
    assert res.losses[-1] < 0.01 * res.losses[0]
    assert abs(res.sdf.radius.item() - 1.0) < 0.05
    np.testing.assert_allclose(res.sdf.rgb.detach().numpy(), [0.8, 0.3, 0.2], atol=0.05)


def test_fit_leaves_the_callers_scene_alone():
    start = start_sdf()
    res = fit(start, target_image(), steps=2)
    assert start.radius.item() == pytest.approx(0.7) and start.radius.grad is None
    assert res.sdf is not start and res.sdf.radius.item() != start.radius.item()


def test_progress_callback():
    seen = []
    res = fit(start_sdf(), target_image(), steps=3, progress=lambda s, l: seen.append((s, l)))
    assert [s for s, _ in seen] == [0, 1, 2]
    assert [l for _, l in seen] == res.losses and all(isinstance(l, float) for l in res.losses)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    tgt = target_image()
    full = fit(start_sdf(), tgt, steps=20, learning_rate=0.03)
    ckpt = tmp_path / "ckpt"
    first = fit(start_sdf(), tgt, steps=10, learning_rate=0.03, checkpoint_dir=ckpt,
                checkpoint_every=5)
    assert first.resumed_from is None
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000005.pt", "step_00000010.pt"]
    resumed = fit(start_sdf(), tgt, steps=20, learning_rate=0.03, checkpoint_dir=ckpt,
                  checkpoint_every=5)
    assert resumed.resumed_from == 10 and resumed.steps_run == 10
    np.testing.assert_allclose(resumed.losses, full.losses[10:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(resumed.sdf.radius.item(), full.sdf.radius.item(), atol=1e-5)
    np.testing.assert_allclose(resumed.sdf.rgb.detach().numpy(), full.sdf.rgb.detach().numpy(),
                               atol=1e-5)
    # Two checkpoints are kept, and nothing is left under a temporary name.
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000015.pt", "step_00000020.pt"]


def test_checkpoint_of_another_scene_is_refused(tmp_path):
    fit(start_sdf(), target_image(), steps=1, checkpoint_dir=tmp_path)
    other = st.sphere(0.7) | st.box(0.3)
    with pytest.raises(ValueError, match="leaves"):
        fit(other, target_image(), steps=2, checkpoint_dir=tmp_path)


def test_fit_csg_tree_params():
    # Gradients flow through a CSG tree: fit the translation of one lobe.
    def lobes(m, x):
        return m.sphere(0.6).translate(x, 0, 0) | m.sphere(0.6).translate(-0.5, 0, 0)

    tgt = np.asarray(sk.render(lobes(sk, 0.5), W, H))
    res = fit(lobes(st, 0.3), tgt, steps=150, learning_rate=0.01)
    assert res.losses[-1] < 0.6 * res.losses[0]
    assert abs(res.sdf.a.offset[0].item() - 0.5) < 0.1


def palette_scene(m, table):
    return m.sphere(0.55).repeat_indexed("xy", (1.25, 1.25), table)


def test_palette_converges_to_target():
    """Only the palette is optimized (the geometry already matches): the
    caller's optimizer is a factory over the parameter list."""
    target_table = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]]
    tgt = np.asarray(sk.render(palette_scene(sk, jnp.asarray(target_table)), W, H))
    start = palette_scene(st, np.full((2, 3), 0.5, np.float32))

    def table_only(params):
        return torch.optim.Adam([p for p in params if tuple(p.shape) == (2, 3)], lr=0.05)

    res = fit(start, tgt, steps=120, optimizer=table_only)
    assert res.losses[-1] < 0.05 * res.losses[0]
    np.testing.assert_allclose(res.sdf.table.detach().numpy(), target_table, atol=0.1)
    assert res.sdf.child.radius.item() == pytest.approx(0.55)


def test_palette_steps_track_the_jax_fit():
    # The repeated-sphere frame is mostly silhouette pixels, where rounding
    # differences between two programs compound through the optimizer steps:
    # the JAX package's own bound between its backends here is rtol 3e-2.
    # Three steps: the loss rises on this frame (every leaf moves at once), and
    # at the fourth step the two programs' trajectories are 8% apart.
    target_table = jnp.asarray([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]])
    tgt = np.asarray(sk.render(palette_scene(sk, target_table), W, H))
    rj = jax_fit(palette_scene(sk, jnp.full((2, 3), 0.5)), tgt, steps=3, learning_rate=0.03,
                 backend="jnp")
    rt = fit(palette_scene(st, np.full((2, 3), 0.5, np.float32)), tgt, steps=3,
             learning_rate=0.03)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=3e-2, atol=1e-5)
    np.testing.assert_allclose(rt.sdf.table.detach().numpy(), np.asarray(rj.sdf.table),
                               rtol=3e-2, atol=1e-3)


def test_backend_choice_on_the_cpu():
    tgt = target_image()
    with pytest.raises(ValueError, match="CUDA"):
        fit(start_sdf(), tgt, steps=1, backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        fit(start_sdf(), tgt, steps=1, backend="fused")
    with pytest.raises(TypeError, match="mesh"):
        fit(start_sdf(), tgt, steps=1, mesh=object())
    # A parallel.Mesh is taken: a mesh of one is what fit runs without one.
    from sdfkit_tpu_torch.parallel.distributed import single

    on_mesh = fit(start_sdf(), tgt, steps=2, mesh=single("cpu"))
    np.testing.assert_array_equal(on_mesh.losses, fit(start_sdf(), tgt, steps=2).losses)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        fit(start_sdf(), tgt[..., 0], steps=1)
    assert fit(start_sdf(), tgt, steps=1, backend="torch").steps_run == 1


@pytest.mark.parametrize("scale,clipped", [(0.1, False), (10.0, True)])
def test_clip_by_global_norm_matches_optax(scale, clipped):
    import optax

    rng = np.random.default_rng(7)
    grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in ((), (3,), (2, 3))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(np.array(g))
    clip_by_global_norm_(params, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    norm = np.sqrt(sum(float((p.grad ** 2).sum()) for p in params))
    assert (norm == pytest.approx(1.0, rel=1e-5)) == clipped
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


# -- what the render's gradient cannot see ----------------------------------------

HERO_W, HERO_H = 192, 108
HERO_EYE = (-2.0, 2.0, 4.0)


def _hero_radius_slopes(r0):
    """(autograd, finite-difference) slope of the image loss in the sphere
    radius of SphereRepeat at ``r0``, against the frame at radius 0.5."""
    from sdfkit_tpu_torch import scenes

    hero = scenes.sphere_repeat_scene()
    view = st.look_at(HERO_EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    marcher = st.RayMarcher(HERO_W, HERO_H, hero, view=view)
    radius = st.leaves(hero)[0]

    def loss_at(r):
        with torch.no_grad():
            radius.fill_(r)
        return torch.mean((marcher.render() - target) ** 2)

    with torch.no_grad():
        target = marcher.render().clone()
    loss_at(r0).backward()
    e = 1e-3
    with torch.no_grad():
        fd = (loss_at(r0 + e) - loss_at(r0 - e)).item() / (2 * e)
    return radius.grad.item(), fd


def test_sphere_repeat_radius_gradient_has_no_silhouette_term():
    """The sphere tracer's gradient (in both packages) differentiates the
    shading of the pixels a shape covers, not the change of which pixels it
    covers. On SphereRepeat, a frame of many small silhouettes, that is the
    larger part: below the target radius the radius's gradient points away
    from the target while finite differences point toward it. Above it the
    two agree in sign. This is why the full-size fit in chip_smoke.py starts
    at 0.55 and moves the radius alone."""
    ad, fd = _hero_radius_slopes(0.45)
    print(f"radius 0.45: autograd {ad:+.4f}, finite differences {fd:+.4f}")
    assert ad > 0.5 and fd < -0.3
    ad, fd = _hero_radius_slopes(0.55)
    print(f"radius 0.55: autograd {ad:+.4f}, finite differences {fd:+.4f}")
    assert ad > 0.2 and fd > 0.2

    # The JAX package's gradient at 0.45 has the same sign.
    import jax

    from bench import sphere_repeat_scene
    from sdfkit_tpu.render.raymarch import RenderConfig, render_rays
    from sdfkit_tpu.utils.camera import camera_rays

    cfg = RenderConfig(width=HERO_W, height=HERO_H)
    view = sk.look_at(HERO_EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    ro, rd = camera_rays(HERO_W, HERO_H, view, cfg.vfov_degrees, cfg.near, cfg.far)
    leaves, treedef = jax.tree_util.tree_flatten(sphere_repeat_scene())
    target = render_rays(jax.tree_util.tree_unflatten(treedef, leaves), ro, rd, cfg)

    @jax.jit
    def loss(r):
        scene = jax.tree_util.tree_unflatten(treedef, [r, *leaves[1:]])
        return jnp.mean((render_rays(scene, ro, rd, cfg) - target) ** 2)

    jad = float(jax.grad(loss)(jnp.float32(0.45)))
    jfd = float(loss(jnp.float32(0.451)) - loss(jnp.float32(0.449))) / 2e-3
    print(f"JAX package, radius 0.45: jax.grad {jad:+.4f}, finite differences {jfd:+.4f}")
    assert jad > 0.5 and jfd < -0.3


def test_sphere_repeat_fit_of_the_radius_alone_descends_from_above():
    """The counterpart of chip_smoke.py's full-size fit at a CPU size: from
    radius 0.55, Adam on the radius alone lowers the loss at every step;
    from 0.45 with every leaf free (clip + Adam) the loss rises."""
    from sdfkit_tpu_torch import scenes

    hero = scenes.sphere_repeat_scene()
    view = st.look_at(HERO_EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    with torch.no_grad():
        target = st.RayMarcher(HERO_W, HERO_H, hero, view=view).render().clone()
        st.leaves(hero)[0].fill_(0.55)
    res = fit(hero, target, steps=5, view=view,
              optimizer=lambda leaves: torch.optim.Adam([leaves[0]], lr=2e-3))
    print(f"radius alone from 0.55: losses {res.losses}, radius {st.leaves(res.sdf)[0].item()}")
    assert all(b < a for a, b in zip(res.losses, res.losses[1:]))
    assert 0.5 < st.leaves(res.sdf)[0].item() < 0.55
    with torch.no_grad():
        st.leaves(hero)[0].fill_(0.45)
    res = fit(hero, target, steps=5, view=view, learning_rate=1e-2)
    print(f"every leaf from 0.45: losses {res.losses}, radius {st.leaves(res.sdf)[0].item()}")
    assert res.losses[-1] > res.losses[0] and st.leaves(res.sdf)[0].item() < 0.45
