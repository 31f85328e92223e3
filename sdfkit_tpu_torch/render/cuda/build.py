"""Build the kernels for one scene structure with nvcc; load them with ctypes.

The counterpart of ``sdfkit_tpu/native/__init__.py`` (build on first use,
load with ctypes), for the GPU: the scene compiler's C++ and the hand-written
kernel sources under ``csrc/`` go into one generated translation unit, which
``nvcc`` compiles for ``sm_90a`` into a shared library with a plain C
interface under ``sdfkit_tpu_torch/_build/``.

* One library per kernel family and scene structure, each built at its first
  use (``FAMILIES``): the image forward (``load``), the image backward
  (``load_bwd``), their depth-history variants (``store=True``: the same
  sources with ``SDF_STORE`` defined), the ray-batch forward (``load_rays``)
  and the ray-batch backward (``load_rays_bwd``). Forward libraries hold
  ``sdf_dist`` and ``sdf_eval`` and are named by the program hash; backward
  libraries hold the emitted adjoints too and are named by the adjoint hash.
  A scene that is only rendered builds the image forward and nothing else. A
  parameter edit keeps both hashes, so it costs no build.
* A library holds one kernel template in its RGB and its depth instance
  (and, for a backward, the partial-sum kernel; the ray-batch forward also
  has an RGB instance that writes hit flags), so the ``ptxas -v`` report is
  keyed ``rgb`` / ``depth`` / ``reduce`` (``rgb_hit``) whatever the family
  (``kernel_key``). Each library also says how many of its blocks an SM
  holds at once (``resident``).
* A library reads its parameters and view from constant memory, or from
  device memory where they do not fit in the 64 KB bank
  (``csrc/raymarch_uniforms.cuh`` decides from ``SDF_N_PARAMS``): a scene of
  any size builds.
* ``BUILDS`` counts nvcc runs in this process. Importing the package never
  runs nvcc. ``LOADS`` counts the libraries loaded (built or not) and
  ``LOAD_SECONDS`` their seconds, nvcc's included, summed over threads.
* No ``--use_fast_math``: the kernels rely on IEEE ``/``, ``sqrtf`` and ``fmaf``.
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
import threading
import time

from sdfkit_tpu_torch.sdf.compile import Program
from sdfkit_tpu_torch.utils.spans import span

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILDS = 0  # nvcc runs in this process
LOADS = 0  # libraries loaded in this process (load_family's misses)
LOAD_SECONDS = 0.0  # the seconds those loads took, nvcc's included, summed over threads
_COUNTS = threading.Lock()


@dataclasses.dataclass
class KernelLib:
    launch: ctypes._CFuncPtr
    path: pathlib.Path
    build_seconds: float | None  # None when an earlier process built it
    registers: dict  # {"rgb": n, "depth": n[, "reduce": n]} from ptxas, when built here
    local_memory: dict  # per kernel: stack frame and spill bytes ptxas printed
    rows: ctypes._CFuncPtr | None = None  # backward: (count, want_color) -> partial rows
    store: bool = False  # the depth-history variant of its family
    resident: ctypes._CFuncPtr | None = None  # (want_color) -> resident blocks per SM
    # The stream of the library's last launch on each card (by index) and a
    # lock around a launch: its uniforms are one buffer per card that every
    # launch there overwrites (``order_uniforms``).
    last_streams: dict = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def order_uniforms(self, stream) -> None:
        """Make ``stream``, about to launch through this library, wait for the
        library's last launch on the same card where that was on another
        stream: both write that card's copy of the library's uniforms. Each
        card holds a copy of its own, so launches on two cards wait for
        nothing. Call it with ``lock`` held."""
        last = self.last_streams.get(stream.device_index)
        if last is not None and last != stream:
            stream.wait_event(last.record_event())
        self.last_streams[stream.device_index] = stream


_LIBS: dict[tuple, KernelLib] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc was not found (PATH, $CUDA_HOME/bin): the CUDA kernel cannot be built")


_HEAD = "#include <cuda_runtime.h>\n#include <math.h>\n\n"


_P = ctypes.c_void_p
_IMAGE_ARGS = [
    _P, _P,  # params, view19
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # depth0, near, far
    ctypes.c_int,  # want_color
]
_RAYS_ARGS = [
    _P, _P, _P, _P, _P, _P, _P,  # params, ox, oy, oz, dx, dy, dz
    ctypes.c_int, ctypes.c_int,  # n, iters
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # depth0, near, far
    ctypes.c_int,  # want_color
]


@dataclasses.dataclass(frozen=True)
class Family:
    """One kernel library. ``csrc/<prefix>.cu`` defines ``<prefix>_launch``
    and ``<prefix>_resident`` and, for a backward, ``<prefix>_rows`` and
    ``<prefix>_n_out``."""

    prefix: str
    argtypes: tuple  # of ``<prefix>_launch``
    adjoint: bool = False  # a backward: holds the emitted adjoints, named by the adjoint hash
    store: bool = False  # built with SDF_STORE defined
    view_outputs: int = 0  # a backward's outputs beyond the parameter slots


_FWD_HEADERS = ("raymarch_fwd.cuh", "raymarch_uniforms.cuh")
_BWD_HEADERS = (*_FWD_HEADERS, "raymarch_bwd.cuh", "raymarch_reduce.cuh")
_FWD_ARGS = (*_IMAGE_ARGS, _P, _P, _P)  # out, store, stream
# grad, store, partials, rows, out, stream
_BWD_ARGS = (*_IMAGE_ARGS, _P, _P, _P, ctypes.c_int, _P, _P)
FAMILIES = {
    "fwd": Family("raymarch_fwd", _FWD_ARGS),
    "fwd_store": Family("raymarch_fwd", _FWD_ARGS, store=True),
    "bwd": Family("raymarch_bwd", _BWD_ARGS, adjoint=True, view_outputs=19),
    "bwd_store": Family("raymarch_bwd", _BWD_ARGS, adjoint=True, store=True, view_outputs=19),
    "rays_fwd": Family("raymarch_rays_fwd", (*_RAYS_ARGS, _P, _P, _P)),  # out, hit, stream
    # grad, hit, g_rays, depths, partials, rows, out, stream
    "rays_bwd": Family("raymarch_rays_bwd",
                       (*_RAYS_ARGS, _P, _P, _P, _P, _P, ctypes.c_int, _P, _P), adjoint=True),
}


def translation_unit(program: Program, family: str = "fwd") -> str:
    """The generated .cu of one family: the scene's functions (and their
    adjoints, for a backward), then the kernel source."""
    fam = FAMILIES[family]
    unit = _HEAD + program.source + "\n"
    if fam.adjoint:
        unit += program.adjoint_source + "\n"  # defines SDF_N_PARAMS (and SDF_LARGE) itself
    else:
        unit += f"#define SDF_N_PARAMS {program.n_params}\n"
        if program.large:
            unit += "#define SDF_LARGE 1\n"
    if fam.store:
        unit += "#define SDF_STORE 1\n"
    return unit + f'#include "{fam.prefix}.cu"\n'


def kernel_key(mangled: str) -> str:
    """``rgb`` / ``depth`` / ``reduce`` for a kernel of a library, from its
    mangled name: the first template argument of a render kernel is
    WANT_COLOR, and the ray-batch forward's second, WANT_HIT, adds ``_hit``."""
    if "reduce" in mangled:
        return "reduce"
    m = re.search(r"ILb([01])E(?:Lb([01])E)?", mangled)
    key = "rgb" if m and m.group(1) == "1" else "depth"
    return key + "_hit" if m and m.group(2) == "1" else key


def _ptxas(log: str) -> tuple[dict, dict]:
    """Registers per thread and local-memory bytes (stack frame, spills) of
    each kernel, from ptxas -v; and the local memory of each function of
    the scene's that is not inlined (the large tier's adjoints), under its
    name."""
    registers, local = {}, {}
    current = function = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current, function = kernel_key(m.group(1)), None
            continue
        m = re.search(r"Function properties for _Z(\d+)(\w+)", line)
        if m and m.group(2).startswith("sdf_"):
            function = m.group(2)[:int(m.group(1))]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (function or current):
            local.setdefault(function or current, dict(zip(
                ("stack_frame", "spill_stores", "spill_loads"), map(int, m.groups()))))
            function = None
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            registers[current] = int(m.group(1))
            current = None
    return registers, local


def _source_digest(unit: str, sources: tuple[str, ...]) -> str:
    h = hashlib.sha256(unit.encode())
    for name in sources:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:8]


def _compile(stem: str, unit: str) -> tuple[pathlib.Path, float | None, str]:
    """``_build/<stem>.so`` from ``unit``: (path, nvcc seconds or None when
    the library was already there, the compiler's output).

    Processes that build one stem at once (the ranks of a process group)
    each write their own source and library under a per-process name and
    rename them into place: nvcc never reads a source another process is
    writing, and the last rename leaves a whole library. A failed build
    leaves neither file behind."""
    global BUILDS
    so = BUILD_DIR / f"{stem}.so"
    if so.exists():
        return so, None, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.cu"
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    try:
        src.write_text(unit)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {stem}.cu:\n{log}")
        os.replace(src, BUILD_DIR / f"{stem}.cu")
        os.replace(tmp, so)
    finally:
        src.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    BUILDS += 1
    return so, seconds, log


def load_family(program: Program, family: str) -> KernelLib:
    """The library of ``family`` for ``program``, built on first use."""
    global LOADS, LOAD_SECONDS
    fam = FAMILIES[family]
    name = program.adjoint_hash if fam.adjoint else program.hash
    lib = _LIBS.get((family, name))
    if lib is not None:
        return lib
    t0 = time.perf_counter()
    with span("sdf.build"):
        lib = _LIBS[(family, name)] = _load(program, fam, family, name)
    with _COUNTS:
        LOADS += 1
        LOAD_SECONDS += time.perf_counter() - t0
    return lib


def _load(program: Program, fam: Family, family: str, name: str) -> KernelLib:
    """Build (where this checkout has not) and load the library of ``family``."""
    unit = translation_unit(program, family)
    headers = _BWD_HEADERS if fam.adjoint else _FWD_HEADERS
    digest = _source_digest(unit, (*headers, fam.prefix + ".cu"))
    so, seconds, log = _compile(f"raymarch_{family}_{name}_{digest}", unit)
    cdll = ctypes.CDLL(str(so))
    fn = getattr(cdll, fam.prefix + "_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = list(fam.argtypes)
    resident = getattr(cdll, fam.prefix + "_resident")
    resident.restype = ctypes.c_int
    resident.argtypes = [ctypes.c_int]
    rows = None
    if fam.adjoint:
        rows = getattr(cdll, fam.prefix + "_rows")
        rows.restype = ctypes.c_int
        rows.argtypes = [ctypes.c_int, ctypes.c_int]
        n_out = getattr(cdll, fam.prefix + "_n_out")
        n_out.restype = ctypes.c_int
        n_out.argtypes = []
        if n_out() != program.n_params + fam.view_outputs:
            raise RuntimeError(
                f"{so} was built for {n_out() - fam.view_outputs} parameter slots, "
                f"the program has {program.n_params}"
            )
    registers, local = _ptxas(log)
    return KernelLib(launch=fn, path=so, build_seconds=seconds, registers=registers,
                     local_memory=local, rows=rows, store=fam.store, resident=resident)


def load(program: Program, store: bool = False) -> KernelLib:
    """The image forward library for ``program``; ``store=True`` is the build
    that also writes the depth history."""
    return load_family(program, "fwd_store" if store else "fwd")


def load_bwd(program: Program, store: bool = False) -> KernelLib:
    """The image backward library for ``program``, built at the first
    backward through that structure; ``store=True`` is the build that reads
    the forward's depth history instead of replaying the march."""
    return load_family(program, "bwd_store" if store else "bwd")


def load_rays(program: Program) -> KernelLib:
    """The ray-batch forward library for ``program``."""
    return load_family(program, "rays_fwd")


def load_rays_bwd(program: Program) -> KernelLib:
    """The ray-batch backward library for ``program``."""
    return load_family(program, "rays_bwd")
