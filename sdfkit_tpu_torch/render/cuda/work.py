"""What the sphere-trace kernels must do for a frame, and the least time an
H100 could take for it.

One count for every caller (``chip_smoke.py``'s "work:" lines,
``tools/torch_scaling.py``'s work per rank, ``bench_torch.py``'s roofline):
the operations are nodes of the scene's compiled program
(``sdf.compile.operation_counts``, not instructions) plus the fixed work
around them that this module names, and the bytes are each input read once
and each output written once. A bound is the larger of operations over the
card's float32 rate and bytes over its memory rate (``bound_ms``).

Two forms of a forward's work: the *fixed work* marches every pixel every
step and shades it; the work *the frame needs* counts each ray's steps up to
its bitwise fixed point (``march_steps_needed``, which the forwards leave
the march at) and shades only the rays that hit. The backward's work is
always the frame's: every pixel replays the march, only a hit pixel taps,
sweeps and pulls the shading back.

The instruction counts (``forward_loop_instructions``,
``backward_loop_instructions``) read a library's loops from its SASS
(``sass.scene_loops``) and give the thread instructions a launch executes in
them, for its share of the rate at which the card starts instructions
(``instruction_rate``).
"""

from __future__ import annotations

import dataclasses

import torch

from sdfkit_tpu_torch.sdf.compile import Program, operation_counts

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, HBM3.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

STEP_OPS = 7  # a march step around the distance: ro + rd * depth, and the depth's add
SHADE_OPS = 60  # a pixel's ray, normalisations, Lambert and the sky select
TAPS = 6  # the finite-difference normal's distance evaluations
RAY_OPS = 30  # a camera ray: two NDC coordinates, four 3-term rows, three divides, a normalisation
RAY_VJP_OPS = 60  # its pullback to the 19 view scalars
# Around one unit gradient of a sweep step, besides the distance's adjoint:
# the point (6), grad d . rd (5), the gradient times the depth (3), the ray's
# six sums (12) and the recurrence (2); the multiply of each parameter
# slot's scaled add is slots_added more (the slots one evaluation adds to:
# every slot the distance reads in the small tier, the taken path's in the
# large one, operation_counts).
UNIT_OPS = 28
SM_LANES = 128  # instructions an SM starts per cycle, one per lane


def bound_ms(operations: float, nbytes: float) -> tuple[float, str]:
    """(the least milliseconds for ``operations`` and ``nbytes``, and which
    of ``"operations"`` / ``"bytes"`` sets it)."""
    by_ops, by_bytes = operations / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


@dataclasses.dataclass(frozen=True)
class Work:
    """The operations and bytes of one launch."""

    operations: int
    bytes: int

    def bound(self) -> tuple[float, str]:
        return bound_ms(self.operations, self.bytes)


def _fixed_per_pixel(counts: dict, iterations: int) -> int:
    return (iterations - 1 + TAPS) * (counts["dist"] + STEP_OPS) + counts["eval"] + SHADE_OPS


def fixed_operations_per_pixel(program: Program, iterations: int) -> int:
    """Operations of one pixel marched every step: ``iterations - 1``
    distance steps and the six taps, one colour evaluation, the shading."""
    return _fixed_per_pixel(operation_counts(program), iterations)


def march_steps_needed(settled: torch.Tensor, iterations: int) -> int:
    """The march steps the rays of ``settled`` (``render.raymarch.settled_steps``
    of a depth history) need: a ray's settled step plus the one that shows
    it, at most ``iterations - 1``."""
    return int(torch.clamp(settled + 1, max=iterations - 1).sum())


def frame_work(program: Program, iterations: int, pixels: int, hits: int, march_steps: int,
               ray_hits: int | None = None, ray_march_steps: int | None = None) -> dict:
    """``{kernel: Work}`` of the kernels over a frame of ``pixels`` pixels
    of which ``hits`` hit, whose rays need ``march_steps`` march steps:

    * ``fwd`` / ``fwd_fixed``: the image forward as the frame needs it and as
      fixed work; ``bwd``: the image backward (replay and sweep);
    * ``fwd_store`` / ``fwd_store_fixed`` / ``bwd_store``: the forward that
      also writes the depth history, and the backward fed it (no replay);
    * with ``ray_hits`` and ``ray_march_steps`` (the ray-batch forward's own,
      over the frame's rays): ``rays_fwd`` / ``rays_fwd_fixed``,
      ``rays_bwd`` (the tangent march on the rays that hit; in the large
      tier their replay and sweep) and ``rays_bwd_as_replay`` (the same
      pullback done as the image backward's replay and sweep, without the
      ray's generation and its pullback)."""
    c = operation_counts(program)
    n = iterations
    step = c["dist"] + STEP_OPS
    uniforms = 4 * (program.n_params + 19)
    fwd_bytes = pixels * 12 + uniforms
    bwd_bytes = pixels * 12 + 2 * uniforms
    store_bytes = pixels * n * 4
    fixed = pixels * _fixed_per_pixel(c, n)

    def forward(steps, hit_count):
        """A ray marches until its fixed point, then evaluates colour; one
        that hits taps and is shaded, one that misses takes the sky
        (about its ray's operations)."""
        return (steps * step + pixels * c["eval"] + hit_count * (TAPS * step + SHADE_OPS)
                + (pixels - hit_count) * RAY_OPS)

    fwd = forward(march_steps, hits)
    unit = c["dist_unit"] + UNIT_OPS + c["slots_added"]
    bwd = (pixels * ((n - 1) * step + c["eval"] + RAY_OPS)
           + hits * (TAPS * step + (TAPS + n - 1) * unit + c["eval_vjp"] + 3 * SHADE_OPS))
    out = {
        "fwd": Work(fwd, fwd_bytes),
        "fwd_fixed": Work(fixed, fwd_bytes),
        "bwd": Work(bwd, bwd_bytes),
        "fwd_store": Work(fwd, fwd_bytes + store_bytes),
        "fwd_store_fixed": Work(fixed, fwd_bytes + store_bytes),
        "bwd_store": Work(bwd - pixels * (n - 1) * step, bwd_bytes + store_bytes),
    }
    if ray_hits is not None and ray_march_steps is not None:
        # The ray-batch kernels make no rays; they read six floats a ray,
        # and the pullback writes six. Its tangent step: a unit gradient
        # with its distance, the point, s = 1 + u . rd and the derivatives'
        # multiply-adds (2 per parameter slot, 12 for the ray).
        rays_in = pixels * 24
        tangent = c["dist_unit"] + UNIT_OPS + 2 * c["dist_slots"]
        out["rays_fwd"] = Work(forward(ray_march_steps, ray_hits) - pixels * RAY_OPS,
                               fwd_bytes + rays_in)
        out["rays_fwd_fixed"] = Work(fixed - pixels * RAY_OPS, fwd_bytes + rays_in)
        rays_bwd_bytes = pixels * (24 + 12 + 1 + 24) + 8 * program.n_params
        out["rays_bwd"] = Work(
            ray_hits * ((n - 1) * tangent + c["eval"] + TAPS * step + TAPS * unit
                        + c["eval_vjp"] + 3 * SHADE_OPS), rays_bwd_bytes)
        if program.large:
            # The large tier replays and sweeps the rays the forward hit.
            out["rays_bwd"] = Work(
                ray_hits * ((n - 1) * (step + unit) + c["eval"] + TAPS * step + TAPS * unit
                            + c["eval_vjp"] + 3 * SHADE_OPS), rays_bwd_bytes)
        out["rays_bwd_as_replay"] = Work(bwd - pixels * RAY_OPS - hits * RAY_VJP_OPS,
                                         bwd_bytes + 2 * rays_in)
    return out


def instruction_rate(sms: int, clock_mhz: float) -> float:
    """Thread instructions the card starts per second: one per lane and
    cycle, ``SM_LANES`` lanes an SM."""
    return sms * SM_LANES * clock_mhz * 1e6


def forward_loop_instructions(loops: list, roots: int, every: int, warp_steps: torch.Tensor,
                              iterations: int) -> dict | None:
    """Thread instructions a forward executes in its march loops, from its
    innermost loops that evaluate the scene (``sass.scene_loops``: the group
    of ``every`` steps with the fixed-point test, then the steps that fill
    no group) and the steps each warp of 32 runs
    (``render.raymarch.warp_march_steps``). ``roots`` is the square roots of
    one distance evaluation. None where the first loop is not a group of
    ``every`` steps."""
    if every is None or not loops or loops[0]["rsq"] != every * roots:
        return None
    n = iterations
    full = (n - 1) // every
    groups = torch.clamp(warp_steps, max=every * full) // every
    group_passes = int(groups.sum())
    rest_passes = int((warp_steps - every * groups).sum())
    group = loops[0]
    rest_per = loops[1]["own"] * roots / loops[1]["rsq"] if len(loops) > 1 else group["own"] / every
    n_warps = warp_steps.numel()
    return {
        "per_step": group["own"] / every,
        "rest_per_step": rest_per,
        "warp_steps": int(warp_steps.sum()),
        "warps": n_warps,
        "in_loops": 32 * (group_passes * group["own"] + rest_passes * rest_per),
        "fixed": 32 * n_warps * (full * group["own"] + (n - 1 - every * full) * rest_per),
    }


def backward_loop_instructions(loops: list, roots: int, pixels: int, hits: int,
                               iterations: int) -> dict | None:
    """Thread instructions the image backward executes in its loops, in
    address order the replay, the taps' forward pass, the taps' unit
    gradients (three passes of two evaluations each) and the sweep: every
    pixel replays, a hit pixel also taps and sweeps. None where the SASS
    shows fewer loops."""
    if len(loops) < 4:
        return None
    replay, tap_fwd, tap_unit, sweep = loops[:4]
    n = iterations
    per_replay = replay["own"] * roots / replay["rsq"]
    per_sweep = sweep["own"] * roots / sweep["rsq"]
    return {
        "per_replay_step": per_replay,
        "per_tap": [tap_fwd["own"] / 2, tap_unit["own"] / 2],
        "per_sweep_step": per_sweep,
        "in_loops": (pixels * (n - 1) * per_replay
                     + hits * (3 * tap_fwd["own"] + 3 * tap_unit["own"] + (n - 1) * per_sweep)),
    }


__all__ = ["PEAK_BYTES", "PEAK_FP32_OPS", "Work", "backward_loop_instructions", "bound_ms",
           "fixed_operations_per_pixel", "forward_loop_instructions", "frame_work",
           "instruction_rate", "march_steps_needed"]
