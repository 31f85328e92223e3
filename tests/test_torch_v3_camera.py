"""The port's V3 and camera against the JAX package (CPU).

Both packages invert 4x4 float32 matrices, through different LAPACK paths,
and XLA's tan is an ulp off the correctly rounded one torch returns: hence
rtol 1e-5 / atol 1e-6 for matrices and rays. Floor-mod is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfkit_tpu.utils import camera as jcam
from sdfkit_tpu.utils import v3 as jv3
import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.utils import camera as tcam
from sdfkit_tpu_torch.utils import v3 as tv3

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

VIEWS = [
    ((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
    ((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0)),
    ((5.0, 0.5, 0.3), (0.2, -0.1, 0.0)),
]
SIZES = [(17, 13), (40, 24)]
UP = (0.0, 1.0, 0.0)


@pytest.mark.parametrize("eye,target", VIEWS)
def test_look_at_matches_jax(eye, target):
    j = np.asarray(jcam.look_at(eye, target, UP))
    t = tcam.look_at(eye, target, UP).numpy()
    assert t.dtype == np.float32 and t.shape == (4, 4)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w,h", SIZES)
def test_perspective_fov_matches_jax(w, h):
    j = np.asarray(jcam.perspective_fov(jnp.deg2rad(jnp.float32(60.0)), w / h, 1.0, 100.0))
    t = tcam.perspective_fov(torch.deg2rad(torch.tensor(60.0)), w / h, 1.0, 100.0).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("eye,target", VIEWS)
def test_camera_rays_match_jax(eye, target, w, h):
    jro, jrd = jcam.camera_rays(w, h, jcam.look_at(eye, target, UP))
    tro, trd = tcam.camera_rays(w, h, tcam.look_at(eye, target, UP))
    for jc, tc in zip((jro.x, jro.y, jro.z, jrd.x, jrd.y, jrd.z),
                      (tro.x, tro.y, tro.z, trd.x, trd.y, trd.z)):
        assert tuple(tc.shape) == (h, w)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


def test_camera_rays_y_flip_and_ndc_corners():
    # Row 0 is the image top: its rays point up (rd.y > 0 from the default view).
    _, rd = tcam.camera_rays(17, 13, tcam.default_view())
    assert float(rd.y[0, 8]) > 0 > float(rd.y[-1, 8])
    assert float(rd.x[6, 0]) < 0 < float(rd.x[6, -1])


def test_vmod_floor_semantics_on_negative_inputs():
    rng = np.random.default_rng(0)
    a = (-rng.random(4096) * 20.0).astype(np.float32)
    b = np.float32(1.125)
    t = tv3.vmod(torch.from_numpy(a), float(b)).numpy()
    j = np.asarray(jv3.vmod(jnp.asarray(a), b))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, a - b * np.floor(a / b))
    assert (t >= 0).all() and (t <= b).all()  # floor-mod, not C's fmodf
    assert not np.array_equal(t, np.fmod(a, b))


def test_v3_safe_ops_match_jax():
    rng = np.random.default_rng(1)
    pts = (rng.random((3, 256)) * 4 - 2).astype(np.float32)
    pts[:, :8] = 0.0  # the zero vector: finite, zero
    jp = jv3.V3(*(jnp.asarray(c) for c in pts))
    tp = tv3.V3(*(torch.from_numpy(c.copy()) for c in pts))
    np.testing.assert_allclose(tp.zero_safe_length().numpy(), np.asarray(jp.zero_safe_length()),
                               rtol=1e-6, atol=1e-7)
    jn, tn = jp.safe_normalize(), tp.safe_normalize()
    for jc, tc in zip((jn.x, jn.y, jn.z), (tn.x, tn.y, tn.z)):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert np.all(tn.x.numpy()[:8] == 0)


def test_zero_safe_length_backward_is_finite_at_zero():
    x = torch.zeros(4, requires_grad=True)
    tv3.V3(x, x * 0, x * 0).zero_safe_length().sum().backward()
    assert torch.isfinite(x.grad).all()
