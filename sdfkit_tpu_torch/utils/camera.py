"""Camera matrices with System.Numerics semantics, in float32 torch.

Counterpart of ``sdfkit_tpu/utils/camera.py``: row vectors (``v' = v @ M``),
right-handed, the reference's CreateLookAt and CreatePerspectiveFieldOfView
layouts, so the committed goldens transfer.
"""

from __future__ import annotations

import torch

from sdfkit_tpu_torch.device import resolve
from sdfkit_tpu_torch.utils.v3 import V3


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def look_at(camera_position, camera_target, camera_up, device=None) -> torch.Tensor:
    """Row-vector view matrix, right-handed (System.Numerics CreateLookAt),
    on ``device`` or the package's default device (the card)."""
    device = resolve(device)
    pos = _f32(camera_position, device)
    target = _f32(camera_target, device)
    up = _f32(camera_up, device)
    zaxis = pos - target
    zaxis = zaxis / torch.linalg.vector_norm(zaxis)
    xaxis = torch.linalg.cross(up, zaxis)
    xaxis = xaxis / torch.linalg.vector_norm(xaxis)
    yaxis = torch.linalg.cross(zaxis, xaxis)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    one = torch.ones((), dtype=torch.float32, device=pos.device)
    return torch.stack(
        [
            torch.stack([xaxis[0], yaxis[0], zaxis[0], zero]),
            torch.stack([xaxis[1], yaxis[1], zaxis[1], zero]),
            torch.stack([xaxis[2], yaxis[2], zaxis[2], zero]),
            torch.stack([-(xaxis @ pos), -(yaxis @ pos), -(zaxis @ pos), one]),
        ]
    )


def perspective_fov(vfov_radians, aspect, near, far, device=None) -> torch.Tensor:
    """Row-vector perspective matrix (System.Numerics
    CreatePerspectiveFieldOfView), on ``device`` or the default device."""
    device = resolve(device)
    y_scale = 1.0 / torch.tan(_f32(vfov_radians, device) * 0.5)
    x_scale = y_scale / _f32(aspect, device)
    near_t = _f32(near, device)
    neg_far_range = _f32(far, device) / (near_t - _f32(far, device))
    zero = torch.zeros_like(y_scale)
    one = torch.ones_like(y_scale)
    return torch.stack(
        [
            torch.stack([x_scale, zero, zero, zero]),
            torch.stack([zero, y_scale, zero, zero]),
            torch.stack([zero, zero, neg_far_range, -one]),
            torch.stack([zero, zero, near_t * neg_far_range, zero]),
        ]
    )


def inv_view_proj(view: torch.Tensor, width: int, height: int, vfov_degrees,
                  near, far) -> tuple[torch.Tensor, torch.Tensor]:
    """(inverse(view @ proj) as (4, 4), camera position as (3,)), on the
    view's device. ``inv_ex`` leaves out the error check that would wait for
    the device."""
    cam_tf = torch.linalg.inv_ex(view)[0]
    proj = perspective_fov(
        torch.deg2rad(_f32(vfov_degrees, view.device)), width / height, near, far,
        device=view.device,
    )
    ivp = torch.linalg.inv_ex(view @ proj)[0]
    return ivp, cam_tf[3, :3]


def camera_rays(width: int, height: int, view: torch.Tensor, vfov_degrees=60.0,
                near=1.0, far=100.0) -> tuple[V3, V3]:
    """Per-pixel ray origins and directions, row 0 = top of image.

    Unprojects NDC points (x, y, 0, 1) through inverse(view @ proj) as the
    reference does: the NDC range uses /(width-1) and /(height-1), guarded
    by max(., 1), and y is flipped."""
    ivp, cam_pos = inv_view_proj(view, width, height, vfov_degrees, near, far)
    dev = view.device
    wden = max(width - 1, 1)
    hden = max(height - 1, 1)
    xs = -1.0 + 2.0 * torch.arange(width, dtype=torch.float32, device=dev) / wden
    ys = 1.0 - 2.0 * torch.arange(height, dtype=torch.float32, device=dev) / hden
    x = xs[None, :].expand(height, width)
    y = ys[:, None].expand(height, width)

    # (x, y, 0, 1) @ ivp, written out to keep the structure-of-arrays layout.
    hx = x * ivp[0, 0] + y * ivp[1, 0] + ivp[3, 0]
    hy = x * ivp[0, 1] + y * ivp[1, 1] + ivp[3, 1]
    hz = x * ivp[0, 2] + y * ivp[1, 2] + ivp[3, 2]
    hw = x * ivp[0, 3] + y * ivp[1, 3] + ivp[3, 3]

    pos = V3(hx / hw, hy / hw, hz / hw)
    ro = V3(
        cam_pos[0].expand(height, width),
        cam_pos[1].expand(height, width),
        cam_pos[2].expand(height, width),
    )
    rd = (pos - ro).normalize()
    return ro, rd


DEFAULT_VIEW_EYE = (0.0, 0.0, 5.0)


def default_view(device=None) -> torch.Tensor:
    """Reference default: look-at from (0,0,5) to origin, +Y up."""
    return look_at(DEFAULT_VIEW_EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device=device)
