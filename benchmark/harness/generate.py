"""The one generator: every input of a run from its configuration, its
traffic mix and ``--seed``. The same seed gives the same inputs.

* Views: the configuration's camera (``view``: ``eye``, ``target``,
  ``up``) moved along its ``orbit`` about the vertical axis through the
  target: ``circle`` turns the eye all the way round, ``swing`` back and
  forth within ``amplitude_degrees``; ``degrees_per_frame`` apart. The
  path repeats after ``period`` frames, and the seed picks the frame it
  starts at.
* Tables: the scene's parameters (``reference/<kind>.table``), with the
  entries that a fit's ``start`` or ``target`` names drawn from the seed
  on the device, uniformly in the range given.
"""

from __future__ import annotations

import random

import torch

from benchmark.reference import render as ref


def host_rng(seed: int, stream: str) -> random.Random:
    """A host generator for one use of the seed (Python's own: any integer)."""
    return random.Random(f"{seed}/{stream}")


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def orbit_period(orbit: dict) -> int:
    step = float(orbit["degrees_per_frame"])
    if orbit["kind"] == "circle":
        return round(360.0 / step)
    if orbit["kind"] == "swing":
        return round(4 * float(orbit["amplitude_degrees"]) / step)
    raise ValueError(f"unknown orbit {orbit['kind']!r}")


def orbit_angles(orbit: dict) -> torch.Tensor:
    """Degrees about the vertical axis of each frame of one period."""
    step, period = float(orbit["degrees_per_frame"]), orbit_period(orbit)
    k = torch.arange(period, dtype=torch.float64)
    if orbit["kind"] == "circle":
        return k * step
    amp = float(orbit["amplitude_degrees"])
    return amp - torch.abs(k * step - 2 * amp)  # -amp at k = 0, +amp half a period on


def views(view: dict, device) -> torch.Tensor:
    """(period, 4, 4) view matrices of the configuration's orbit."""
    eye = torch.tensor(view["eye"], dtype=torch.float64)
    target = torch.tensor(view["target"], dtype=torch.float64)
    a = torch.deg2rad(orbit_angles(view["orbit"]))
    r = eye - target
    eyes = torch.stack([target[0] + r[0] * torch.cos(a) + r[2] * torch.sin(a),
                        target[1] + r[1].expand_as(a),
                        target[2] - r[0] * torch.sin(a) + r[2] * torch.cos(a)], -1)
    return ref.look_at(eyes.float().to(device), view["target"], view["up"], device)


def first_frame(view: dict, seed: int) -> int:
    """The frame of the orbit a run starts at."""
    return host_rng(seed, "orbit").randrange(orbit_period(view["orbit"]))


def fixed_view(view: dict, device) -> torch.Tensor:
    return ref.look_at(view["eye"], view["target"], view["up"], device)


def drawn(table: dict, ranges: dict, seed: int, stream: str, device) -> dict:
    """``table`` with each entry named in ``ranges`` drawn uniformly in its
    [low, high) from the seed, on the device, in the entry's shape."""
    gen = device_generator(seed + sum(map(ord, stream)), device)
    out = dict(table)
    for name, (lo, hi) in sorted(ranges.items()):
        out[name] = lo + (hi - lo) * torch.rand(table[name].shape, generator=gen, device=device)
    return out


def render_config(config: dict) -> dict:
    r = config["render"]
    return {"width": int(r["width"]), "height": int(r["height"]),
            "vfov_degrees": float(r["vfov_degrees"]), "near": float(r["near"]),
            "far": float(r["far"]), "iterations": int(r["iterations"])}


def march_kwargs(cfg: dict) -> dict:
    """The render settings as the port's ``RayMarcher`` and ``fit`` take them."""
    return {"vfov_degrees": cfg["vfov_degrees"], "near": cfg["near"], "far": cfg["far"],
            "depth_iterations": cfg["iterations"]}

