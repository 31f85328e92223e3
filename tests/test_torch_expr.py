"""Every node type and constructor of the port against the JAX package.

The same scene is built in both packages (``torch_parity.build``), the JAX
leaves are perturbed with numpy's seeded generator and carried across with
``load_leaves``, and ``expr(points)`` is compared at 4096 seeded points in
[-3, 3]^3. Both evaluate op by op in IEEE float32 (JAX eagerly), so the
tolerance is a few ulps: rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")


def _points(seed=0, n=4096):
    return (np.random.default_rng(seed).random((n, 3)) * 6 - 3).astype(np.float32)


@pytest.mark.parametrize("name", tp.NAMES)
def test_eval_matches_jax(name):
    jexpr, texpr = tp.build(name, perturb_seed=7)
    pts = _points()
    j = np.asarray(jexpr(pts))
    with torch.no_grad():
        t = texpr(torch.from_numpy(pts)).numpy()
    assert t.shape == (4096, 4)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", tp.NAMES)
def test_leaf_shapes_follow_jax_order(name):
    jexpr, texpr = tp.build(name)
    assert [tuple(p.shape) for p in st.leaves(texpr)] == tp.jax_leaf_shapes(jexpr)
    assert all(isinstance(p, torch.nn.Parameter) for p in st.leaves(texpr))


def test_load_leaves_rejects_wrong_shape_and_count():
    _, texpr = tp.build("union")
    arrays = [p.detach().numpy().copy() for p in st.leaves(texpr)]
    bad = list(arrays)
    bad[1] = np.zeros((4,), np.float32)  # rgb is (3,)
    with pytest.raises(ValueError, match="shape"):
        st.load_leaves(texpr, bad)
    with pytest.raises(ValueError, match="leaves"):
        st.load_leaves(texpr, arrays[:-1])
    # A rejected load leaves every parameter as it was.
    np.testing.assert_array_equal(st.leaves(texpr)[1].detach().numpy(), arrays[1])


def test_params_receive_gradients_through_eval():
    s = st.sphere(0.5, color=(0.2, 0.4, 0.6)).repeat_indexed(
        "x", (1.0,), [[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]])
    out = s(torch.from_numpy(_points(3, 64)))
    out.sum().backward()
    table = st.leaves(s)[-1]
    assert table.grad is not None and float(table.grad.abs().sum()) > 0


def test_repeat_indexed_validation():
    with pytest.raises(ValueError, match="combine"):
        st.sphere(1.0).repeat_indexed("x", (1.0,), [[1.0, 1.0, 1.0]], combine="bogus")
    with pytest.raises(ValueError, match="axes"):
        st.sphere(1.0).repeat_indexed("w", (1.0,), [[1.0, 1.0, 1.0]])
    with pytest.raises(ValueError, match="sizes"):
        st.sphere(1.0).repeat_indexed("xy", (1.0,), [[1.0, 1.0, 1.0]])
