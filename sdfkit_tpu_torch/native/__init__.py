"""The marching-cubes sparse phase in C++ (``mc_host.cc``), loaded with ctypes.

The port's copy of ``sdfkit_tpu/native``. The library is compiled with the
host's C++ compiler (``CXX``) at its first use, into
``sdfkit_tpu_torch/_build/`` under a name that hashes the sources, and loaded
with ctypes (plain C interface, numpy pointers). Importing this module
compiles nothing.

There is no fallback: when the compiler fails, :func:`lib` raises with the
compiler's own message. (The JAX package drops to numpy instead.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = (_DIR / "mc_host.cc",)
HEADERS = (_DIR / "_mc_luts.h",)
BUILD_DIR = _DIR.parent / "_build"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "mc_sparse_index": (_P, [_P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                             ctypes.c_double]),
    "mc_set_geo_workers": (None, [ctypes.c_int32]),
    "mc_sparse_expected_points": (_I64, [_P]),
    "mc_sparse_geometry": (ctypes.c_int32, [_P, _P, _I64, _I64, _I64, _P]),
    "mc_sparse_color_inputs": (None, [_P, _I64, _I64] + [_P] * 5),
    "mc_sparse_grad_finalize": (None, [_P] * 6),
    "mc_sparse_free": (None, [_P]),
    "mc_sequential_baseline": (_I64, [_P, _P, _I64, _I64, _I64, _I64, ctypes.c_double, _P]),
}


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for path in SOURCES + HEADERS:
        digest.update(path.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"mc_host_{digest.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    """Compile into a per-process temporary file, then rename it into place:
    processes that build at once each write their own file, and the last
    rename leaves a whole library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sources = [str(p) for p in SOURCES]
    # -march=native matters: the corner index does two popcounts a lookup,
    # and without it __builtin_popcountll is a libgcc call. A toolchain that
    # refuses it gets the portable flags.
    errors = []
    for extra in (["-march=native"], []):
        try:
            proc = subprocess.run([CXX, *FLAGS, *extra, *sources, "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"the C++ compiler {CXX!r} could not be run: {e}") from e
        if proc.returncode == 0:
            os.replace(tmp, out)
            return
        errors.append(proc.stderr.strip())
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"{CXX} failed to build {out.name}:\n" + "\n---\n".join(errors))


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                _build(path)
            handle = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = handle
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def set_geo_workers(n: int) -> None:
    """Override ``mc_sparse_geometry``'s worker rule: -1 = auto (the direct
    rolling-layer pass below 4 hardware threads, workers and a merge above),
    1 = the direct pass, >= 2 = that many workers. The tests use it to run
    both dedup implementations on any host."""
    lib().mc_set_geo_workers(int(n))


class McSparse:
    """The C++ sparse geometry over one volume's active cells:

        mc = McSparse(active, lx, ly, lz, nx, ny, nz, step, iso)  # corner index
        mc.geometry(pvals)              # dispatch, welding, interpolation
        ci = mc.color_inputs()          # what the card's colour blends need
        verts, normals, stream = mc.grad_finalize(size3, center3)
        mc.close()

    Every disagreement between the host's corner index and the values the
    card handed over raises ``RuntimeError``: host and card see one grid, so
    a disagreement is a bug, never a case for another path."""

    def __init__(self, active, lx, ly, lz, nx, ny, nz, step, iso):
        self._lib = lib()
        self._active = np.ascontiguousarray(active, np.int64)
        self._handle = self._lib.mc_sparse_index(
            _ptr(self._active), self._active.shape[0], lx, ly, lz, nx, ny, nz, step,
            ctypes.c_double(iso))
        if not self._handle:
            raise RuntimeError(f"an active cell id lies outside the {lx}x{ly}x{lz} cells")

    @property
    def n_active(self) -> int:
        return self._active.shape[0]

    def expected_points(self) -> int:
        """The corner-point count the index expects."""
        return int(self._lib.mc_sparse_expected_points(self._handle))

    def geometry(self, pvals: np.ndarray) -> None:
        """Dispatch, welding and interpolation over every active cell.
        ``pvals``: the unique corner points' values in ascending point id.
        Counts land in ``n_verts``, ``stream_len``, ``n_edge``, ``n_center``."""
        pvals = np.ascontiguousarray(pvals, np.float32)
        counts = np.zeros(4, np.int64)
        ok = self._lib.mc_sparse_geometry(self._handle, _ptr(pvals), pvals.shape[0], 0,
                                          self.n_active, _ptr(counts))
        if not ok:
            raise RuntimeError(f"{pvals.shape[0]} corner values were handed over where the "
                               f"index expects {self.expected_points()}")
        self.n_verts, self.stream_len, self.n_edge, self.n_center = (int(c) for c in counts)

    def color_inputs(self) -> dict:
        """Per new vertex, what the colour blend reads: an edge vertex's id,
        the flat grid id of its cell's base corner and its edge index; a
        centre vertex's id and base corner."""
        ci = {
            "edge_vid": np.empty(self.n_edge, np.int32),
            "edge_base": np.empty(self.n_edge, np.int32),
            "edge_vi": np.empty(self.n_edge, np.uint8),
            "center_vid": np.empty(self.n_center, np.int32),
            "center_base": np.empty(self.n_center, np.int32),
        }
        self._lib.mc_sparse_color_inputs(self._handle, 0, 0, *(_ptr(a) for a in ci.values()))
        return ci

    def grad_finalize(self, size3, center3):
        """Gradient normals and the world transform. Returns (verts f32 (V, 3)
        world, normals f32 (V, 3), triangle stream i32 (S,))."""
        size3 = np.ascontiguousarray(size3, np.float64)
        center3 = np.ascontiguousarray(center3, np.float64)
        verts = np.empty((self.n_verts, 3), np.float32)
        normals = np.empty((self.n_verts, 3), np.float32)
        stream = np.empty(self.stream_len, np.int32)
        self._lib.mc_sparse_grad_finalize(self._handle, _ptr(size3), _ptr(center3), _ptr(verts),
                                          _ptr(normals), _ptr(stream))
        return verts, normals, stream

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.mc_sparse_free(self._handle)
            self._handle = None

    def __enter__(self) -> "McSparse":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def mc_sequential_baseline(values, colors, step: int, iso: float) -> tuple[int, int]:
    """The single-threaded reference-style marching cubes over the whole grid
    (``mc_sequential_baseline`` in ``mc_host.cc``), the yardstick for the
    reference's sequential loop. ``values``: (nx, ny, nz) float32,
    ``colors``: (nx, ny, nz, 3) or None. Returns (n_verts, stream_len)."""
    values = np.ascontiguousarray(values, np.float32)
    nx, ny, nz = values.shape
    cptr = None
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.float32)
        if colors.shape != (nx, ny, nz, 3):
            raise ValueError(f"colors must be {(nx, ny, nz, 3)}, got {colors.shape}")
        cptr = _ptr(colors)
    counts = np.zeros(1, np.int64)
    n_verts = lib().mc_sequential_baseline(_ptr(values), cptr, nx, ny, nz, int(step),
                                           ctypes.c_double(iso), _ptr(counts))
    return int(n_verts), int(counts[0])

