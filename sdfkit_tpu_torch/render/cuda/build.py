"""Build the kernels for one scene structure with nvcc; load them with ctypes.

The counterpart of ``sdfkit_tpu/native/__init__.py`` (build on first use,
load with ctypes), for the GPU: the scene compiler's C++ and the hand-written
kernel sources under ``csrc/`` go into one generated translation unit, which
``nvcc`` compiles for ``sm_90a`` into a shared library with a plain C
interface under ``sdfkit_tpu_torch/_build/``.

* Two libraries per scene structure. The forward one (``sdf_dist``,
  ``sdf_eval`` and ``csrc/raymarch_fwd.cu``) is named by the program hash and
  built at the first render. The backward one (those, the emitted adjoints
  and ``csrc/raymarch_bwd.cu``) is named by the adjoint hash and built at the
  first backward: a scene that is only rendered never pays for it. A
  parameter edit keeps both hashes, so it costs no build.
* ``BUILDS`` counts nvcc runs in this process. Importing the package never
  runs nvcc.
* No ``--use_fast_math``: the kernels rely on IEEE ``/`` and ``sqrtf``.
  nvcc's default FMA contraction stays on, which is why a kernel matches
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
# The backward keeps the march's depth history in a per-thread array of this
# many floats, so it takes at most this many march iterations.
MAX_BWD_ITERS = 64

BUILDS = 0  # nvcc runs in this process


@dataclasses.dataclass
class KernelLib:
    launch: ctypes._CFuncPtr
    path: pathlib.Path
    build_seconds: float | None  # None when an earlier process built it
    registers: dict  # {"rgb": n, "depth": n[, "reduce": n]} from ptxas, when built here
    local_memory: dict  # per kernel: stack frame and spill bytes ptxas printed
    rows: ctypes._CFuncPtr | None = None  # backward: partial rows of a launch


_LIBS: dict[str, KernelLib] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc was not found (PATH, $CUDA_HOME/bin): the CUDA kernel cannot be built")


_HEAD = "#include <cuda_runtime.h>\n#include <math.h>\n\n"


def translation_unit(program: Program) -> str:
    """The generated forward .cu: the scene's functions, then the kernel source."""
    return _HEAD + program.source + '\n#include "raymarch_fwd.cu"\n'


def translation_unit_bwd(program: Program) -> str:
    """The generated backward .cu: the scene's functions and their adjoints,
    then the kernel source."""
    return (_HEAD + program.source + "\n" + program.adjoint_source
            + f'\n#define SDF_MAX_ITERS {MAX_BWD_ITERS}\n#include "raymarch_bwd.cu"\n')


def _ptxas(log: str) -> tuple[dict, dict]:
    """Registers per thread and local-memory bytes (stack frame, spills) of
    each kernel, from ptxas -v."""
    registers, local = {}, {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            current = "reduce" if "reduce" in name else "rgb" if "ILb1E" in name else "depth"
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            local[current] = dict(zip(("stack_frame", "spill_stores", "spill_loads"),
                                      map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            registers[current] = int(m.group(1))
            current = None
    return registers, local


def _source_digest(unit: str, sources: tuple[str, ...]) -> str:
    h = hashlib.sha256(unit.encode())
    for name in sources:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:8]


_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # params, view19
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # depth0, near, far
    ctypes.c_int,  # want_color
]


def _compile(stem: str, unit: str) -> tuple[pathlib.Path, float | None, str]:
    """``_build/<stem>.so`` from ``unit``: (path, nvcc seconds or None when
    the library was already there, the compiler's output)."""
    global BUILDS
    so = BUILD_DIR / f"{stem}.so"
    if so.exists():
        return so, None, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{stem}.cu"
    src.write_text(unit)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
    os.replace(tmp, so)
    BUILDS += 1
    return so, seconds, log


def load(program: Program) -> KernelLib:
    """The forward kernel library for ``program``, built on first use."""
    lib = _LIBS.get(program.hash)
    if lib is not None:
        return lib
    unit = translation_unit(program)
    digest = _source_digest(unit, ("raymarch_fwd.cuh", "raymarch_fwd.cu"))
    so, seconds, log = _compile(f"raymarch_{program.hash}_{digest}", unit)
    fn = ctypes.CDLL(str(so)).raymarch_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [*_FWD_ARGS, ctypes.c_void_p, ctypes.c_void_p]  # out, stream
    registers, local = _ptxas(log)
    lib = _LIBS[program.hash] = KernelLib(
        launch=fn, path=so, build_seconds=seconds, registers=registers, local_memory=local,
    )
    return lib


def load_bwd(program: Program) -> KernelLib:
    """The backward kernel library for ``program``, built at the first
    backward through that structure."""
    key = "bwd_" + program.adjoint_hash
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    unit = translation_unit_bwd(program)
    digest = _source_digest(unit, ("raymarch_fwd.cuh", "raymarch_bwd.cuh", "raymarch_bwd.cu"))
    so, seconds, log = _compile(f"raymarch_bwd_{program.adjoint_hash}_{digest}", unit)
    cdll = ctypes.CDLL(str(so))
    fn = cdll.raymarch_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        *_FWD_ARGS,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # grad, partials, rows
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    rows = cdll.raymarch_bwd_rows
    rows.restype = ctypes.c_int
    rows.argtypes = [ctypes.c_int]
    cdll.raymarch_bwd_n_out.restype = ctypes.c_int
    cdll.raymarch_bwd_n_out.argtypes = []
    if cdll.raymarch_bwd_n_out() != program.n_params + 19:
        raise RuntimeError(
            f"{so} was built for {cdll.raymarch_bwd_n_out() - 19} parameter slots, "
            f"the program has {program.n_params}"
        )
    registers, local = _ptxas(log)
    lib = _LIBS[key] = KernelLib(
        launch=fn, path=so, build_seconds=seconds, registers=registers, local_memory=local,
        rows=rows,
    )
    return lib
