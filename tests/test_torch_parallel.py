"""The sharded paths in one process: a mesh of one rank against the JAX
package's sharded functions on a 4-device virtual CPU mesh, and against the
port's one-device functions.

``jax_refs`` (also read by ``test_torch_distributed.py``, which runs 2 and 4
``gloo`` ranks) computes the JAX package's ``render_sharded`` /
``train_step_sharded`` / ``voxelize_sharded`` / ``create_mesh_sharded`` /
``fit(mesh=)`` at the sizes of ``tools/torch_distributed_demo.py --size
small``, on inputs seeded with numpy. Tolerances:

* the JAX dryrun's (``__graft_entry__.dryrun_multichip``) where one float
  program is compared with itself: a mesh against one rank, loss rtol 1e-5,
  new leaves rtol 5e-5 / atol 5e-5; meshes and voxel values array-equal;
* the port's small-frame contract between two float programs (ROADMAP C.2-
  C.3): RGB max 2e-2 / median 1e-4, depth relative 1e-3 / median 1e-5, leaf
  gradients rtol 2e-3 plus 1e-2 of the largest entry, losses rtol 1e-3
  (``tests/test_torch_fit.py``). A train step's gradient is read back from
  its SGD update, ``(old - new) / lr``; measured against the JAX package:
  0.91% of the largest entry on SphereRepeat 16x7, the loss 1.0e-5 relative.
* mesh colours within the JAX package's float16 rounding (ROADMAP C.9),
  normals within 2e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.fit import fit as jax_fit
from sdfkit_tpu.parallel import create_mesh_sharded as jax_create_mesh_sharded
from sdfkit_tpu.parallel import render_sharded as jax_render_sharded
from sdfkit_tpu.parallel import train_step_sharded as jax_train_step_sharded
from sdfkit_tpu.parallel import voxelize_sharded as jax_voxelize_sharded
from sdfkit_tpu_torch import parallel as par
from sdfkit_tpu_torch import scenes
from sdfkit_tpu_torch.parallel import distributed, marching, train

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

W, H, TRAIN_H, PAL_H = 16, 9, 7, 9
VOX = (8, 8, 9)
LR = 1e-2
FIT = dict(width=24, height=16, steps=2, learning_rate=0.02)


def jax_mesh(n=4):
    return jax.sharding.Mesh(jax.devices()[:n], ("rays",))


def hero(m):
    if m is sk:
        from bench import sphere_repeat_scene

        return sphere_repeat_scene()
    return scenes.sphere_repeat_scene()


def palette(m):
    table = [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2]]
    return m.sphere(0.5).repeat_indexed("xy", (1.125, 1.125),
                                        jnp.asarray(table) if m is sk else table)


def mesh_scene(m):
    return m.sphere(0.5, color=(0.8, 0.4, 0.2))


def fit_target():
    """The fit's target: the port's frame of the larger sphere (seed-free:
    a render), the one the ranks compute."""
    with torch.no_grad():
        return st.RayMarcher(FIT["width"], FIT["height"],
                             st.sphere(1.0, color=(0.8, 0.3, 0.2))).render().numpy()


def target(name):
    """The train step's target: the dryrun's black frame of an odd height for
    SphereRepeat; for the palette scene, an image made with numpy from a
    seed. (On SphereRepeat against such an image the two packages' radius
    gradients are 3.7% of the largest entry apart: the grazing-ray noise of
    ROADMAP C.3, beyond the small-frame contract's 1e-2.)"""
    if name == "train":
        return np.zeros((TRAIN_H, W, 3), np.float32)
    return np.random.default_rng(PAL_H).uniform(size=(PAL_H, W, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_refs():
    """The JAX package's sharded results on a 4-device mesh (numpy)."""
    mesh = jax_mesh()
    view = None  # the dryrun's default view, as the ranks of the small size render
    out = {
        "render_rgb": np.asarray(jax_render_sharded(mesh, hero(sk), W, H, view=view)),
        "render_depth": np.asarray(jax_render_sharded(mesh, hero(sk), W, H, view=view,
                                                      depth_only=True)),
    }
    for name, scene in (("train", hero(sk)), ("pal", palette(sk))):
        new, loss = jax_train_step_sharded(mesh, scene, jnp.asarray(target(name)), view=view,
                                           lr=LR)
        out[f"{name}_loss"] = float(loss)
        out[f"{name}_grads"] = [(np.asarray(a) - np.asarray(b)) / LR for a, b in zip(
            jax.tree_util.tree_leaves(scene), jax.tree_util.tree_leaves(new))]
    vox = jax_voxelize_sharded(mesh, hero(sk), (-1, -1, -1), (1, 1, 1), *VOX)
    out["vox_values"] = np.asarray(vox.values)
    out["vox_colors"] = np.asarray(vox.colors)
    grid = jax_voxelize_sharded(mesh, mesh_scene(sk), (-1, -1, -1), (1, 1, 1), 16, 16, 16)
    out["mesh"] = jax_create_mesh_sharded(mesh, grid)
    res = jax_fit(sk.sphere(0.7, color=(0.4, 0.4, 0.4)), fit_target(), steps=FIT["steps"],
                  learning_rate=FIT["learning_rate"], mesh=mesh)
    out["fit_losses"] = np.asarray(res.losses)
    return out


def port_grads(start, new_leaves):
    """The gradient a train step applied: (old - new) / lr, per leaf."""
    return [(a.detach().numpy() - np.asarray(b).reshape(a.shape)) / LR
            for a, b in zip(st.leaves(start), new_leaves)]


def assert_two_program_grads(got, want):
    """The port's small-frame contract between two float programs
    (``tests/test_torch_kernel_bwd_host.assert_grads_close``'s leaves)."""
    largest = max(float(np.abs(b).max()) for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5 + 1e-2 * largest,
                                   err_msg=f"leaf {i}")


def assert_mesh_matches_jax(vertices, triangles, normals, colors, ref):
    assert len(vertices) > 0
    np.testing.assert_array_equal(vertices, ref.vertices)
    np.testing.assert_array_equal(triangles, ref.triangles)
    np.testing.assert_allclose(normals, ref.normals, atol=2e-5)
    np.testing.assert_allclose(colors, ref.colors, rtol=2.0**-11, atol=1e-6)


ONE = distributed.single("cpu")


# -- the mesh and the process group ------------------------------------------------

def test_the_seven_names_of_the_jax_package_are_exported():
    import sdfkit_tpu.parallel as jpar

    assert set(jpar.__all__) <= set(par.__all__)
    assert set(par.__all__) - set(jpar.__all__) == {"Mesh", "VoxelBricks"}


def test_initialize_is_a_no_op_without_an_address_or_a_launcher(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    par.initialize()
    assert not dist.is_initialized()
    mesh = par.make_mesh()
    assert (mesh.rank, mesh.size, mesh.group, mesh.backend) == (0, 1, None, None)
    assert mesh.device == torch.device("cpu") and mesh.axis_names == ("rays",)
    t = torch.arange(3.0)
    assert mesh.all_gather(t)[0] is t and mesh.all_reduce_sum(t) is t
    mesh.barrier()


def test_a_launchers_environment_starts_the_group(monkeypatch):
    seen = {}
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    par.initialize(world_size=4, rank=0)
    assert seen == {"backend": "gloo", "init_method": None, "world_size": 4, "rank": 0}


@pytest.mark.parametrize("cards,ranks,want", [(0, 4, "gloo"), (1, 4, "gloo"), (1, 1, "nccl"),
                                              (4, 4, "nccl"), (8, 4, "nccl")])
def test_nccl_only_where_every_rank_has_a_card(monkeypatch, cards, ranks, want):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.default_backend(ranks) == want


@pytest.mark.parametrize("height", [1, 7, 9, 16, 1080])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_bands_cover_the_rows_in_rank_order(height, n):
    rows = []
    for r in range(n):
        m = distributed.Mesh(rank=r, size=n, device=torch.device("cpu"))
        rows_local, r0, count = train.band_rows(m, height)
        assert rows_local == -(-height // n) and 0 <= count <= rows_local
        rows += list(range(r0, r0 + count))
    assert rows == list(range(height))


def test_a_mesh_that_is_not_a_mesh_is_refused(tmp_path):
    with pytest.raises(TypeError, match="Mesh"):
        st.fit(st.sphere(1.0), np.zeros((4, 8, 3), np.float32), steps=1, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        par.render_tiles_resumable(st.sphere(1.0), 8, 4, tmp_path / "t", mesh=object())
    assert not (tmp_path / "t").exists()


def test_bricks_of_another_mesh_are_refused():
    other = distributed.Mesh(rank=1, size=2, device=torch.device("cpu"))
    bricks = par.voxelize_sharded(other, mesh_scene(st), (-1, -1, -1), (1, 1, 1), 8, 8, 8)
    assert (bricks.z0, bricks.values.shape[2]) == (4, 4)
    with pytest.raises(ValueError, match="rank 1 of 2"):
        par.create_mesh_sharded(ONE, bricks)


# -- a mesh of one against the JAX package's 4-device mesh and the port ------------

def test_render_sharded_matches_the_jax_mesh_and_the_frame():
    ref = jax_refs()
    view = None
    rgb = par.render_sharded(ONE, hero(st), W, H, view=view)
    depth = par.render_sharded(ONE, hero(st), W, H, view=view, depth_only=True)
    with torch.no_grad():
        marcher = st.RayMarcher(W, H, hero(st), view=view)
        assert torch.equal(rgb, marcher.render()) and torch.equal(depth, marcher.render_depth())
    tp.assert_rgb_close(rgb.numpy(), ref["render_rgb"])
    tp.assert_depth_close(depth.numpy(), ref["render_depth"])


@pytest.mark.parametrize("name", ["train", "pal"])
def test_train_step_matches_the_jax_mesh(name):
    ref = jax_refs()
    start = hero(st) if name == "train" else palette(st)
    new, loss = par.train_step_sharded(ONE, start, target(name), lr=LR)
    np.testing.assert_allclose(loss.item(), ref[f"{name}_loss"], rtol=1e-3)
    assert_two_program_grads(port_grads(start, [p.detach() for p in st.leaves(new)]),
                             ref[f"{name}_grads"])
    fresh = hero(st) if name == "train" else palette(st)
    assert all(torch.equal(a, b) for a, b in zip(st.leaves(start), st.leaves(fresh)))


def test_voxelize_sharded_is_voxelize_and_matches_the_jax_mesh():
    ref = jax_refs()
    bricks = par.voxelize_sharded(ONE, hero(st), (-1, -1, -1), (1, 1, 1), *VOX)
    whole = st.voxelize(hero(st), (-1, -1, -1), (1, 1, 1), *VOX)
    gathered = bricks.gather()
    for got in (bricks, gathered):
        assert torch.equal(got.values, whole.values) and torch.equal(got.colors, whole.colors)
    np.testing.assert_allclose(gathered.values.numpy(), ref["vox_values"], atol=2e-7)
    np.testing.assert_allclose(gathered.colors.numpy(), ref["vox_colors"], atol=2e-7)


@pytest.mark.parametrize("source", ["bricks", "voxels"])
def test_create_mesh_sharded_is_to_mesh_and_matches_the_jax_mesh(source):
    ref = jax_refs()
    bricks = par.voxelize_sharded(ONE, mesh_scene(st), (-1, -1, -1), (1, 1, 1), 16, 16, 16)
    vox = bricks if source == "bricks" else bricks.gather()
    seen = []
    got = par.create_mesh_sharded(ONE, vox, progress=seen.append)
    want = bricks.gather().to_mesh()
    assert seen == [0.0, 1.0]
    for f in ("vertices", "triangles", "normals", "colors"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert_mesh_matches_jax(got.vertices, got.triangles, got.normals, got.colors, ref["mesh"])


def test_an_empty_grid_meshes_to_nothing():
    outside = par.voxelize_sharded(ONE, st.sphere(0.1).translate(5.0, 0.0, 0.0), (-1, -1, -1),
                                   (1, 1, 1), 8, 8, 8)
    assert len(par.create_mesh_sharded(ONE, outside).vertices) == 0
    flat = par.voxelize_sharded(ONE, mesh_scene(st), (-1, -1, -1), (1, 1, 1), 8, 8, 1)
    assert len(par.create_mesh_sharded(ONE, flat).vertices) == 0


def test_fit_over_a_mesh_of_one_tracks_the_jax_mesh_fit(tmp_path):
    ref = jax_refs()
    start = st.sphere(0.7, color=(0.4, 0.4, 0.4))
    res = st.fit(start, fit_target(), steps=FIT["steps"], learning_rate=FIT["learning_rate"],
                 mesh=ONE)
    np.testing.assert_allclose(res.losses, ref["fit_losses"], rtol=1e-3, atol=1e-5)
    plain = st.fit(start, fit_target(), steps=FIT["steps"], learning_rate=FIT["learning_rate"])
    np.testing.assert_allclose(res.losses, plain.losses, rtol=1e-5)
    # Checkpoints from the mesh's rank 0, and a resume.
    st.fit(start, fit_target(), steps=1, learning_rate=FIT["learning_rate"], mesh=ONE,
           checkpoint_dir=tmp_path, checkpoint_every=1)
    again = st.fit(start, fit_target(), steps=FIT["steps"], learning_rate=FIT["learning_rate"],
                   mesh=ONE, checkpoint_dir=tmp_path)
    assert again.resumed_from == 1 and again.steps_run == FIT["steps"] - 1
    np.testing.assert_allclose(again.losses, res.losses[1:], rtol=1e-6)


def test_tiles_over_a_mesh_of_one_are_the_tiles(tmp_path):
    img, stats = par.render_tiles_resumable(hero(st), 24, 10, tmp_path / "m", tile_rows=4,
                                            mesh=ONE)
    ref, _ = par.render_tiles_resumable(hero(st), 24, 10, tmp_path / "n", tile_rows=4)
    np.testing.assert_array_equal(img, ref)
    assert stats == {"resumed": 0, "rendered": 3, "tiles": 3}


# -- the halo and the cell stream, on a mesh of one ---------------------------------

def test_the_last_brick_pads_its_halo_and_a_brick_thinner_than_the_step_reads_on():
    brick = torch.arange(2 * 2 * 3, dtype=torch.float32).view(2, 2, 3)
    ext = marching._halo_exchange(ONE, brick, 2)
    assert ext.shape == (2, 2, 5)
    assert torch.equal(ext[:, :, :3], brick) and not ext[:, :, 3:].any()
    assert marching._brick_layout(16, 1, 4) == (15, 4)
    assert marching._brick_layout(7, 3, 4) == (2, 2)


def test_the_cell_stream_gives_the_corner_points_of_the_whole_grid():
    vox = st.voxelize(mesh_scene(st), (-1, -1, -1), (1, 1, 1), 12, 10, 9)
    from sdfkit_tpu_torch.mesh import marching_cubes as mc

    lx, ly, lz = 11, 9, 8
    ext = marching._halo_exchange(ONE, vox.values, 1)
    ids, v8 = marching._classify_brick(ext, 0.0, 0, 9, 1, lx, ly, lz)
    mask = mc._classify_slab(vox.values, 0.0, 0, 1, lx, ly, lz)
    assert torch.equal(ids, torch.nonzero(mask.reshape(-1)).squeeze(1))
    points = vox.values[:lx + 1, :ly + 1, :lz + 1].permute(2, 1, 0)[mc._point_mask(mask)]
    assert torch.equal(marching._point_values(ids, v8, lx, ly, lz), points)
