"""A rank of ``tools/torch_distributed_demo.py`` with the g++ loops of
``torch_host.py`` in place of the CUDA launches, so that the kernel route's
band plumbing (the padded last band, the backward once per band) runs on CPU
tensors too. ``test_torch_distributed.py`` spawns it through
``torch_distributed_demo.launch(worker=...)``; ``--host-kernels DIR`` names
the directory where the test process built the scenes' libraries (the ranks
load them, never compile)."""

import importlib
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests"), str(REPO / "tools")]

import pytest  # noqa: E402
import torch_distributed_demo as demo  # noqa: E402
from torch_host import host_libraries, patch_kernels  # noqa: E402

from sdfkit_tpu_torch.parallel import elastic, train  # noqa: E402
from sdfkit_tpu_torch.render import raymarch  # noqa: E402


def main() -> int:
    ap = demo.parser()
    ap.add_argument("--host-kernels", required=True)
    a = ap.parse_args()
    fit = importlib.import_module("sdfkit_tpu_torch.fit")  # the package exports the function
    mp = pytest.MonkeyPatch()
    calls = patch_kernels(mp, host_libraries(pathlib.Path(a.host_kernels)))
    # The kernel backend on CPU tensors; "auto" stays the plain route there.
    for module, name in ((raymarch, "resolve_backend"), (fit, "resolve_backend"),
                         (elastic, "resolve_backend"), (train, "resolve_shard_backend")):
        mp.setattr(module, name, lambda backend, sdf: "torch" if backend == "auto" else backend)
    return demo.run_worker(a, host_calls=calls)


if __name__ == "__main__":
    sys.exit(main())
