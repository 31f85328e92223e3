"""What the compiler made of a kernel library: instructions and loops from SASS.

``operation_counts`` of the scene compiler counts nodes of a program; the
card executes instructions, several for an IEEE division or square root. This
module reads ``cuobjdump -sass`` of a built library and finds each kernel's
loops (a branch to a lower address closes one), so that a run can say how
many instructions one pass of the march loop or of the sweep executes, and how
many scene evaluations that pass holds (a square root is one ``MUFU.RSQ``
and a division or reciprocal one ``MUFU.RCP``, whatever else they expand to).
Nothing here runs on import, and nothing in the render path uses it.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

from sdfkit_tpu_torch.render.cuda.build import kernel_key, nvcc_path

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump_path() -> str | None:
    """``cuobjdump`` beside nvcc or on the PATH, or None."""
    beside = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    return beside if os.path.exists(beside) else shutil.which("cuobjdump")


def parse_sass(text: str) -> dict:
    """``{kernel key: {"instructions": n, "loops": [...]}}`` from the text of
    ``cuobjdump -sass``. A loop is ``{"start", "end"}`` (addresses),
    ``"instructions"`` (all between them), ``"own"`` (those not in a loop
    nested in it) and, of its own instructions, ``"rsq"``, ``"rcp"``,
    ``"fchk"`` (the range check of an IEEE division), ``"loads"`` (from
    device, local, shared or constant memory as an instruction of its own;
    a constant operand is not one), ``"stores"`` (to device memory) and
    ``"votes"`` (a warp vote, the forwards' test for a warp at its fixed
    point), in address order."""
    kernels: dict[str, list] = {}
    current = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = kernels.setdefault(kernel_key(m.group(1)), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for key, instructions in kernels.items():
        ends: dict[int, int] = {}  # loop start -> its last back edge
        for address, op, operands in instructions:
            target = _TARGET.search(operands)
            # A branch to itself is the trap that ends every kernel, not a loop.
            if op.startswith("BRA") and target and int(target.group(1), 16) < address:
                start = int(target.group(1), 16)
                ends[start] = max(ends.get(start, 0), address)
        spans = sorted(ends.items())
        loops = []
        for start, end in spans:
            inner = [(s, e) for s, e in spans if (s, e) != (start, end) and start <= s and e <= end]
            body = [(a, op) for a, op, _ in instructions if start <= a <= end]
            own = [op for a, op in body if not any(s <= a <= e for s, e in inner)]
            loops.append({
                "start": start, "end": end, "instructions": len(body), "own": len(own),
                "rsq": sum(op == "MUFU.RSQ" for op in own),
                "rcp": sum(op == "MUFU.RCP" for op in own),
                "fchk": sum(op == "FCHK" for op in own),
                "loads": sum(op.split(".")[0] in ("LD", "LDG", "LDL", "LDS", "LDC") for op in own),
                "stores": sum(op.split(".")[0] in ("ST", "STG") for op in own),
                "votes": sum(op.split(".")[0] == "VOTE" for op in own),
            })
        out[key] = {"instructions": len(instructions), "loops": loops}
    return out


def library_sass(path) -> dict | None:
    """:func:`parse_sass` of the built library at ``path``, or None where the
    toolkit has no ``cuobjdump`` or it fails."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    try:
        proc = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return parse_sass(proc.stdout) if proc.returncode == 0 else None


def scene_loops(listing: dict, key: str = "rgb") -> list:
    """The innermost loops of kernel ``key`` of a :func:`parse_sass` listing
    that evaluate the scene (they take a square root; a grid-stride loop
    holds others), in address order."""
    return [lp for lp in listing[key]["loops"] if lp["rsq"] > 0 and lp["own"] == lp["instructions"]]


def per_evaluation(loop: dict, roots_per_evaluation: int) -> float | None:
    """Instructions one pass of ``loop`` executes per scene evaluation in it,
    the evaluations counted by their square roots; None for a loop without
    any."""
    if roots_per_evaluation <= 0 or loop["rsq"] == 0:
        return None
    return loop["own"] * roots_per_evaluation / loop["rsq"]


__all__ = ["cuobjdump_path", "kernel_key", "library_sass", "parse_sass", "per_evaluation",
           "scene_loops"]
