"""The readings that the correctness limits are set from, beside the
program's own: the control and the faults, each put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the plain reference computed in bfloat16, the precision
below the float32 that every configuration states (the render has no
matrix product that TF32 would reach: its view's inverse is the only one,
and the reference computes it in float32 with TF32 off). The cell's loop
(``loops/<loop>.py``, ``control_readings``) says what is read: for a
frames cell the frames a run would check; for a fit cell the steps a run
follows, and the loss at the parameters they reached. A fit cell also
reads two faults, planted in the float32
reference: ``half_rows`` leaves the frame's lower half out of the loss and
takes the mean over the rest; ``altered`` adds 0.1 to the first 64 rows of
every frame where the render produces it. And a look, no fault:
``nudged``, the same reference with the camera moved by 1e-6 along z, says
how far a number moves when nothing but rounding changes. (A step that leaves its state
unchanged reads 1 on ``change_gap`` by its definition, and one card has no
exchange to leave out.) Each reading is the same numbers a run compares,
against the float32 reference, printed as one JSON line a seed and kind.
``benchmark.run`` never runs this.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    read = spec.loop(cell.traffic["loop"]).control_readings
    for seed in args.seeds:
        for kind, numbers in read(cell, seed, "cuda").items():
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
