"""The benchmark's plain reference against the port's plain path, on the
CPU at 64x36: the frame bit for bit, the gradient of a fit's loss in every
leaf, and the march's needs against the port's own history."""

from __future__ import annotations

import pytest
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render.raymarch import RayMarcher, march_history, settled_steps
from sdfkit_tpu_torch.utils.camera import camera_rays

from benchmark.harness import generate, spec
from benchmark.reference import render as ref

CELLS = ("sphere_repeat_1080p.frames_orbit", "union_grid_4_1080p.fit_colours",
         "union_grid_200_1080p.fit_colours")
W, H = 64, 36


def _setup(name):
    cell = spec.load_cell(name)
    cell.config["render"].update(width=W, height=H)
    cfg = generate.render_config(cell.config)
    ref_mod, port_mod = spec.scene_modules(cell.config["scene"]["kind"])
    table = ref_mod.table(cell.config["scene"], "cpu")
    view = generate.fixed_view(cell.config["view"], "cpu")
    expr = port_mod.build(table, "cpu")
    return cell, cfg, ref_mod, port_mod, table, view, expr


@pytest.mark.parametrize("name", CELLS)
def test_frame_equals_the_port_plain_path(name):
    cell, cfg, ref_mod, _, table, view, expr = _setup(name)
    want = RayMarcher(W, H, expr, view=view, backend="torch",
                      **generate.march_kwargs(cfg)).render().detach()
    assert torch.equal(ref.render(ref_mod, table, view, cfg), want)


def _gradients(name):
    """A fit's loss of the cell's scene at 64x36 through both sides, the
    losses compared: (the port's scene module, its scene with the gradients
    in its leaves, the trained entry, the table, the reference's
    gradients)."""
    cell, cfg, ref_mod, port_mod, table, view, expr = _setup(name)
    trained, drawn = (("sphere_radius", [0.45, 0.46]) if "sphere_radius" in table
                      else ("color", [0.2, 1.0]))
    aim = generate.drawn(table, {trained: drawn}, 7, "target", "cpu")
    target = ref.render(ref_mod, aim, view, cfg)
    loss, grads = ref.loss_and_grads(ref_mod, table, view, target, cfg, block_pixels=W * 7)
    frame = RayMarcher(W, H, expr, view=view, backend="torch",
                       **generate.march_kwargs(cfg)).render()
    port_loss = ((frame - target) ** 2).sum() / (W * H * 3)
    port_loss.backward()
    assert float(loss) == pytest.approx(port_loss.item(), rel=1e-5)
    return port_mod, expr, trained, table, grads


def _gap(port_mod, expr, entry, grads) -> float:
    """The largest gap of an entry's gradient over its largest value."""
    got = torch.stack([p.grad.reshape(-1) if p.grad is not None else torch.zeros(p.numel())
                       for p in port_mod.leaves(expr, entry)])
    want = grads[entry].reshape(got.shape)
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def test_the_small_fits_trained_gradient_matches_the_port_plain_path():
    """The 4-sphere fit's colour leaves within 1e-5 of the largest entry."""
    port_mod, expr, trained, _, grads = _gradients("union_grid_4_1080p.fit_colours")
    assert _gap(port_mod, expr, trained, grads) <= 1e-5


@pytest.mark.parametrize("name", CELLS[::2])
def test_gradient_matches_the_port_plain_path(name):
    """The leaf a fit trains within 1e-5 of its largest entry. Every other
    leaf within 2e-3: a position's or a cell size's gradient sums terms of
    both signs over the pixels, and the two sides sum them in another
    order (the reference over a batch of spheres, a block of rows at a
    time)."""
    port_mod, expr, trained, table, grads = _gradients(name)
    for entry in table:
        tol = 1e-5 if entry == trained else 2e-3
        assert _gap(port_mod, expr, entry, grads) <= tol, entry


@pytest.mark.parametrize("name", CELLS)
def test_march_needs_equal_the_port_history(name):
    cell, cfg, ref_mod, _, table, view, expr = _setup(name)
    needs = ref.march_needs(ref_mod, table, view, cfg, block_pixels=W * 5)
    ro, rd = camera_rays(W, H, view)
    render_cfg = st.RenderConfig(W, H)
    with torch.no_grad():
        steps = settled_steps(march_history(expr, ro, rd, render_cfg).reshape(40, -1))
    assert needs["pixels"] == W * H
    assert needs["steps"] == int(torch.clamp(steps + 1, max=39).sum())
    assert 0 < needs["hits"] <= W * H and needs["hit_steps"] <= needs["steps"]


def test_adam_equals_torch_adam():
    params = {"a": torch.tensor([0.3, -1.0]), "b": torch.tensor(2.0)}
    leaf = params["a"].clone().requires_grad_()
    opt = torch.optim.Adam([leaf], lr=0.05)
    mine = ref.Adam(["a"], 0.05)
    for g in ([0.5, -2.0], [0.1, 0.3], [-1.0, 4.0]):
        leaf.grad = torch.tensor(g)
        opt.step()
        params = mine.step(params, {"a": torch.tensor(g), "b": torch.tensor(1.0)})
    assert torch.allclose(params["a"], leaf.detach(), rtol=1e-6, atol=1e-7)
    assert float(params["b"]) == 2.0
