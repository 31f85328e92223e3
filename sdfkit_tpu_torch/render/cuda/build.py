"""Build the forward kernel for one scene structure with nvcc; load it with ctypes.

The counterpart of ``sdfkit_tpu/native/__init__.py`` (build on first use,
load with ctypes), for the GPU: the scene compiler's C++ (``sdf_dist``,
``sdf_eval``) and the hand-written ``csrc/raymarch_fwd.cu`` go into one
generated translation unit, which ``nvcc`` compiles for ``sm_90a`` into a
shared library with a plain C interface under ``sdfkit_tpu_torch/_build/``.

* One library per scene structure, named by the program hash. A parameter
  edit keeps the hash, so it costs no build.
* ``BUILDS`` counts nvcc runs in this process. Importing the package never
  runs nvcc; the first render of a new structure does.
* No ``--use_fast_math``: the kernel relies on IEEE ``/`` and ``sqrtf``.
  nvcc's default FMA contraction stays on, which is why the kernel matches
  the plain path distributionally and not per pixel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

from sdfkit_tpu_torch.sdf.compile import Program

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILDS = 0  # nvcc runs in this process


@dataclasses.dataclass
class KernelLib:
    launch: ctypes._CFuncPtr
    path: pathlib.Path
    build_seconds: float | None  # None when an earlier process built it
    registers: dict  # {"rgb": n, "depth": n} from ptxas, when built here


_LIBS: dict[str, KernelLib] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc was not found (PATH, $CUDA_HOME/bin): the CUDA kernel cannot be built")


def translation_unit(program: Program) -> str:
    """The generated .cu: the scene's functions, then the kernel source."""
    return (
        "#include <cuda_runtime.h>\n#include <math.h>\n\n"
        + program.source
        + '\n#include "raymarch_fwd.cu"\n'
    )


def _registers(log: str) -> dict:
    """Registers per thread of each kernel instantiation, from ptxas -v."""
    out = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = "rgb" if "ILb1E" in m.group(1) else "depth"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            out[current] = int(m.group(1))
            current = None
    return out


def _source_digest(unit: str) -> str:
    h = hashlib.sha256(unit.encode())
    for name in ("raymarch_fwd.cuh", "raymarch_fwd.cu"):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:8]


def _bind(path: pathlib.Path) -> ctypes._CFuncPtr:
    lib = ctypes.CDLL(str(path))
    fn = lib.raymarch_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # params, view19
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # depth0, near, far
        ctypes.c_int,  # want_color
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    return fn


def load(program: Program) -> KernelLib:
    """The kernel library for ``program``, built on first use."""
    global BUILDS
    lib = _LIBS.get(program.hash)
    if lib is not None:
        return lib
    unit = translation_unit(program)
    stem = f"raymarch_{program.hash}_{_source_digest(unit)}"
    so = BUILD_DIR / f"{stem}.so"
    seconds, log = None, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / f"{stem}.cu"
        src.write_text(unit)
        tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
        os.replace(tmp, so)
        BUILDS += 1
    lib = _LIBS[program.hash] = KernelLib(
        launch=_bind(so), path=so, build_seconds=seconds, registers=_registers(log),
    )
    return lib
