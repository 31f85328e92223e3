"""The benchmark's plain sphere tracer: camera, march, normals, shading.

A frozen rewrite in plain PyTorch of the reference renderer's semantics
(praeclarum/SdfKit ``RayMarcher``), written apart from the program it
judges. Nothing here imports the program. Every function takes the scene
as ``scene.eval(params, p)``, ``p`` a tuple ``(x, y, z)`` of tensors, which
returns ``((r, g, b), distance)``; the scene modules beside this one
(``sphere_repeat.py``, ``union_grid.py``) provide it.

The renderer's rules:

* depth starts at ``near - 0.1`` and takes a fixed ``iterations - 1``
  distance steps, with no early exit and no hit threshold;
* the last step evaluates colour and distance together: the diffuse colour
  is that sample's, and the final depth adds its distance;
* a pixel whose depth passed ``far`` is sky (0.5, 0.75, 1.0);
* normals are 6-tap central differences with eps 1e-5, Lambert from a
  point light at (5, 5, 10) plus 0.1 ambient.

Everything runs in ``dtype`` (float32 for the reference; the benchmark's
precision control runs the same code in bfloat16). TF32 is switched off
before any matrix product (``no_tf32``).
"""

from __future__ import annotations

import contextlib
import math

import torch

EPS = 1e-5
LIGHT = (5.0, 5.0, 10.0)
AMBIENT = 0.1
SKY = (0.5, 0.75, 1.0)


@contextlib.contextmanager
def no_tf32():
    """Matrix products in full float32 inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# -- vectors as (x, y, z) tuples ---------------------------------------------

def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def length(a):
    return torch.sqrt(dot(a, a))


def safe_normalize(a, eps: float = 1e-30):
    """The floor inside the root: the zero vector maps to zero."""
    return scale(a, torch.rsqrt(torch.clamp_min(dot(a, a), eps)))


def where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


# -- the camera (System.Numerics conventions: row vectors, right-handed) -----

def look_at(eye, target, up, device, dtype=torch.float32) -> torch.Tensor:
    """The (4, 4) view matrix of ``eye`` looking at ``target``; ``eye`` may
    be an (n, 3) tensor, giving (n, 4, 4)."""
    eye = torch.as_tensor(eye, dtype=dtype, device=device)
    single = eye.ndim == 1
    eye = eye.reshape(-1, 3)
    target = torch.as_tensor(target, dtype=dtype, device=device).expand_as(eye)
    up = torch.as_tensor(up, dtype=dtype, device=device).expand_as(eye)
    z = eye - target
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    m = torch.zeros((eye.shape[0], 4, 4), dtype=dtype, device=device)
    m[:, :3, 0], m[:, :3, 1], m[:, :3, 2] = x, y, z
    m[:, 3, 0] = -(x * eye).sum(-1)
    m[:, 3, 1] = -(y * eye).sum(-1)
    m[:, 3, 2] = -(z * eye).sum(-1)
    m[:, 3, 3] = 1.0
    return m[0] if single else m


def perspective(vfov_degrees: float, aspect: float, near: float, far: float, device,
                dtype=torch.float32) -> torch.Tensor:
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    y_scale = 1.0 / torch.tan(torch.deg2rad(f(vfov_degrees)) * 0.5)
    x_scale = y_scale / f(aspect)
    nfr = f(far) / (f(near) - f(far))
    m = torch.zeros((4, 4), dtype=dtype, device=device)
    m[0, 0], m[1, 1], m[2, 2], m[2, 3], m[3, 2] = x_scale, y_scale, nfr, -1.0, f(near) * nfr
    return m


def camera_rays(view: torch.Tensor, cfg: dict, rows: slice | None = None, dtype=torch.float32):
    """(origin, direction) of the pixels in ``rows`` (all rows by default),
    each a tuple of (n_rows, W) tensors; NDC from /(W-1) and /(H-1), y up."""
    width, height = cfg["width"], cfg["height"]
    device = view.device
    with no_tf32():
        v = view.to(torch.float32)
        proj = perspective(cfg["vfov_degrees"], width / height, cfg["near"], cfg["far"], device)
        ivp = torch.linalg.inv(v @ proj).to(dtype)
        cam = torch.linalg.inv(v)[3, :3].to(dtype)
    rows = rows or slice(0, height)
    xs = -1.0 + 2.0 * torch.arange(width, dtype=dtype, device=device) / max(width - 1, 1)
    ys = 1.0 - 2.0 * torch.arange(height, dtype=dtype, device=device)[rows] / max(height - 1, 1)
    x = xs[None, :].expand(ys.shape[0], width)
    y = ys[:, None].expand(ys.shape[0], width)
    h = [x * ivp[0, k] + y * ivp[1, k] + ivp[3, k] for k in range(4)]
    pos = (h[0] / h[3], h[1] / h[3], h[2] / h[3])
    ro = tuple(cam[k].expand_as(x) for k in range(3))
    d = sub(pos, ro)
    n = length(d)
    return ro, (d[0] / n, d[1] / n, d[2] / n)


# -- march and shading --------------------------------------------------------

def march(scene, params, ro, rd, cfg: dict, history: bool = False):
    """(depth, diffuse colour) after the fixed march; with ``history``, also
    the (iterations, ...) depth before each step (the last row the depth
    before the final, colour-taking step)."""
    depth = torch.full_like(ro[0], cfg["near"] - 0.1)
    rows = [depth] if history else None
    for _ in range(cfg["iterations"] - 1):
        depth = depth + scene.distance(params, add(ro, scale(rd, depth)))
        if history:
            rows.append(depth)
    colour, dist = scene.eval(params, add(ro, scale(rd, depth)))
    colour = tuple(torch.broadcast_to(c, dist.shape) for c in colour)
    out = depth + dist, colour
    return (*out, torch.stack(rows)) if history else out


def normal(scene, params, p):
    d = lambda dx, dy, dz: scene.distance(params, (p[0] + dx, p[1] + dy, p[2] + dz))  # noqa: E731
    return safe_normalize((d(EPS, 0.0, 0.0) - d(-EPS, 0.0, 0.0),
                           d(0.0, EPS, 0.0) - d(0.0, -EPS, 0.0),
                           d(0.0, 0.0, EPS) - d(0.0, 0.0, -EPS)))


def shade(scene, params, ro, rd, depth, diffuse, cfg: dict) -> torch.Tensor:
    """(..., 3) RGB. A miss is shaded at a benign depth before the sky
    replaces it, so that its diverged depth puts no NaN into a gradient."""
    bg = depth > cfg["far"]
    surface = add(ro, scale(rd, torch.where(bg, torch.full_like(depth, cfg["near"]), depth)))
    n = normal(scene, params, surface)
    light = safe_normalize(sub(tuple(torch.full_like(depth, c) for c in LIGHT), surface))
    lambert = torch.maximum(dot(n, light), torch.zeros_like(depth))
    lit = tuple(c * lambert + AMBIENT for c in diffuse)
    sky = tuple(torch.full_like(depth, c) for c in SKY)
    return torch.stack(where(~bg, lit, sky), dim=-1)


def render_rows(scene, params, view, cfg: dict, rows: slice, dtype=torch.float32):
    ro, rd = camera_rays(view, cfg, rows, dtype)
    depth, diffuse = march(scene, params, ro, rd, cfg)
    return shade(scene, params, ro, rd, depth, diffuse, cfg)


def row_blocks(cfg: dict, pixels_per_block: int):
    """Slices of whole rows, about ``pixels_per_block`` pixels each."""
    step = max(1, pixels_per_block // cfg["width"])
    return [slice(r, min(r + step, cfg["height"])) for r in range(0, cfg["height"], step)]


def render(scene, params, view, cfg: dict, dtype=torch.float32,
           block_pixels: int = 1 << 19) -> torch.Tensor:
    """(H, W, 3) RGB in float32, computed in ``dtype`` a block of rows at a
    time, with no autograd."""
    params = {k: v.detach().to(dtype) for k, v in params.items()}
    with torch.no_grad():
        return torch.cat([render_rows(scene, params, view, cfg, r, dtype).float()
                          for r in row_blocks(cfg, scene.block_pixels(block_pixels))])


def settled_steps(history: torch.Tensor) -> torch.Tensor:
    """Per ray, the first step that left the depth bit for bit where it was
    (``iterations - 1`` where none did). Every step after it repeats it: a
    march need not run past it."""
    b = history.contiguous().view(torch.int32)
    same = (b[1:] == b[:-1]) & ~torch.isnan(history[1:])
    first = same.int().argmax(0)
    return torch.where(same.any(0), first, torch.full_like(first, history.shape[0] - 1))


def march_needs(scene, params, view, cfg: dict, block_pixels: int = 1 << 19) -> dict:
    """What the frame at ``view`` needs of a march, from this march's own
    depth history: ``pixels``, ``hits`` (final depth within ``far``),
    ``steps`` (each ray's settled step plus the one that shows it, at most
    ``iterations - 1``, summed over all rays) and ``hit_steps`` (the same
    over the rays that hit)."""
    params = {k: v.detach().float() for k, v in params.items()}
    n = cfg["iterations"]
    out = {"pixels": 0, "hits": 0, "steps": 0, "hit_steps": 0}
    with torch.no_grad():
        for rows in row_blocks(cfg, scene.block_pixels(block_pixels)):
            ro, rd = camera_rays(view, cfg, rows)
            depth, _, hist = march(scene, params, ro, rd, cfg, history=True)
            need = torch.clamp(settled_steps(hist.reshape(n, -1)) + 1, max=n - 1)
            hit = (depth <= cfg["far"]).reshape(-1)
            out["pixels"] += hit.numel()
            out["hits"] += int(hit.sum())
            out["steps"] += int(need.sum())
            out["hit_steps"] += int(need[hit].sum())
    return out


def loss_and_grads(scene, params, view, target, cfg: dict, dtype=torch.float32,
                   block_pixels: int = 1 << 19, rows_kept: slice | None = None, alter=None):
    """The mean squared error of the frame against ``target`` (H, W, 3) and
    its gradient in every parameter, by autograd a block of rows at a time
    (the whole frame's tape would not fit). Returns ``(loss, {name: grad})``
    in float32.

    Two faults for the benchmark's control (``control.py``): ``rows_kept``
    restricts the loss to those rows and takes the mean over them, and
    ``alter(rgb, rows)`` changes a block's frame where it is produced."""
    work = {k: v.detach().to(dtype).requires_grad_() for k, v in params.items()}
    height, width = cfg["height"], cfg["width"]
    kept = rows_kept or slice(0, height)
    denom = (kept.stop - kept.start) * width * 3
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    for rows in row_blocks(cfg, scene.block_pixels(block_pixels)):
        rows = slice(max(rows.start, kept.start), min(rows.stop, kept.stop))
        if rows.start >= rows.stop:
            continue
        rgb = render_rows(scene, work, view, cfg, rows, dtype)
        if alter is not None:
            rgb = alter(rgb, rows)
        part = ((rgb - target[rows].to(dtype)) ** 2).sum() / denom
        part.backward()
        total += part.detach().double()
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad).float()
             for k, v in work.items()}
    return total.float(), grads


def frame_loss(scene, params, view, target, cfg: dict, block_pixels: int = 1 << 19) -> float:
    """The mean squared error of the frame against ``target``, with no
    autograd: a fit step's loss at ``params``."""
    rgb = render(scene, params, view, cfg, block_pixels=block_pixels)
    return float(((rgb.double() - target.double()) ** 2).mean())


def fit_steps(scene, params, view, target, cfg: dict, train: str, lr: float, steps: int,
              **faults) -> tuple[list, torch.Tensor, dict]:
    """``steps`` steps of Adam on ``params[train]`` from ``params``: (each
    step's loss, the first step's gradient of ``train``, the parameters
    after). ``faults`` go to ``loss_and_grads``."""
    adam, losses, first = Adam([train], lr), [], None
    for s in range(steps):
        loss, grads = loss_and_grads(scene, params, view, target, cfg, **faults)
        losses.append(float(loss))
        if s == 0:
            first = grads[train]
        params = adam.step(params, grads)
    return losses, first, params


class Adam:
    """torch.optim.Adam's update (betas 0.9 / 0.999, eps 1e-8, no weight
    decay), written out over a dict of tensors."""

    def __init__(self, names, lr: float, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.names, self.lr, self.b1, self.b2, self.eps = list(names), lr, beta1, beta2, eps
        self.t, self.m, self.v = 0, {}, {}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = dict(params)
        for k in self.names:
            g = grads[k]
            self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
            step_size = self.lr / (1 - self.b1 ** self.t)
            denom = self.v[k].sqrt() / math.sqrt(1 - self.b2 ** self.t) + self.eps
            out[k] = params[k] - step_size * self.m[k] / denom
        return out
