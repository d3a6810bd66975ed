"""Build the CUDA kernels (``csrc/*.cu``) with ``nvcc`` and load them with
``ctypes``.

The library is compiled for Hopper (``sm_90a``) at first use on a CUDA
device, into ``portfft_tpu_torch/_build/`` (listed in ``.gitignore``).  Its
file name carries a hash of the sources and flags, so a stale build is never
loaded.  Each C entry point takes raw device pointers and the caller's CUDA
stream, allocates nothing, and returns ``cudaGetLastError()`` after its
launches; :func:`check` raises when that code is not 0.  While a profiler
records, each call of an entry point that launches kernels is a
``portfft.launch`` span (``utils.tracing``).  Importing this module builds
and loads nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import tracing
from ..utils.tracing import PROFILER

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_D = ctypes.c_double
_SUB = [_I, _I, _P, _P, _P, _P, _P, _P]  # m, a, wr, wi, br, bi, ur, ui
_SIGNATURES = {
    "pf_direct": ([_P, _P, _P, _P, _I64, _I, _F, _P], _I),
    "pf_fused2_needs_scratch": ([_I], _I),
    "pf_fused2": ([_P] * 9 + [_I64, _I, _F, _P], _I),
    "pf_fused2_v1": ([_P] * 8 + [_I64, _I, _F, _P], _I),
    "pf_fused2_v2": ([_P] * 8 + [_I64, _I, _I, _F, _P], _I),
    "pf_fused2_v3": ([_P] * 8 + [_I64, _I, _I, _F, _P], _I),
    "pf_global2": ([_P, _P, _P] + _SUB + _SUB + [_P, _P, _I64, _F, _P], _I),
    "pf_global2_ftw": ([_P, _P, _P] + _SUB + _SUB + [_P] * 8 + [_I64, _F, _P], _I),
    "pf_untangle": ([_P, _P, _P, _P, _I64, _I, _F, _P], _I),
    "pf_untangle_wide": ([_P, _P, _P, _P, _I64, _I, _F, _P], _I),
    "pf_retangle": ([_P, _P, _P, _P, _I64, _I, _F, _I, _P], _I),
    "pf_small_real": ([_P, _P, _P, _P, _I64, _I, _I, _F, _P], _I),
    "pf_small_real_f64": ([_P, _P, _P, _P, _I64, _I, _I, _D, _P], _I),
    "pf_col_needs_scratch": ([_I], _I),
    "pf_col": ([_P, _P, _P] + _SUB + [_I64, _I64, _F, _P], _I),
    "pf_col_f64": ([_P, _P, _P] + _SUB + [_I64, _I64, _D, _P], _I),
    "pf_md2": ([_P, _P] + _SUB + _SUB + [_I64, _F, _P], _I),
    "pf_col_mm": ([_P, _P] + _SUB + [_I64, _I64, _F, _P], _I),
    "pf_global3": ([_P] * 3 + [_I, _I] + [_P] * 6 + [_I] + [_P] * 6
                   + [_I] * 3 + [_I64, _F, _P], _I),
    "pf_deinterleave": ([_P, _P, _P, _I64, _P], _I),
    "pf_interleave": ([_P, _P, _P, _I64, _F, _P], _I),
    "pf_chain_needs_scratch": ([_I], _I),
    "pf_chain_general_needs_scratch": ([_I], _I),
    "pf_chain": ([_P] * 5 + _SUB + [_I64, _P], _I),
    "pf_chain_general": (
        [_P] * 5
        + [_I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)]
        + [_I64, _P],
        _I,
    ),
    "pf_chain_cols": ([_P] * 4 + _SUB + [_I64, _I64, _F, _P], _I),
    "pf_chain_general_cols": (
        [_P] * 4
        + [_I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)]
        + [_I64, _I64, _F, _P],
        _I,
    ),
    "pf_bluestein": ([_P] * 6 + [_I64] + _SUB * 4 + [_P] * 10 + [_I64, _F, _P], _I),
    "pf_bluestein_bf": ([_P] * 6 + [_I64] + _SUB * 4 + [_P] * 10 + [_I64, _F, _P],
                        _I),
    "pf_global2_planes_needs_scratch": ([_I, _I], _I),
    "pf_global2_planes": ([_P] * 6 + _SUB + _SUB + [_P] * 4 + [_I64, _F, _P], _I),
    "pf_axis_m2_needs_scratch": ([_I], _I),
    "pf_axis_m2": ([_P] * 5 + _SUB + [_I64, _I64, _F, _P], _I),
    "pf_global_sq": ([_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I64, _F, _P], _I),
    "pf_global_bf": ([_P] * 3 + [_I] * 5 + [_P] * 10 + [_I64, _I64, _F, _P], _I),
    "pf_global_bf_ov": ([_P] * 3 + [_I] * 5 + [_P] * 10 + [_I64, _I64, _F, _P], _I),
    "pf_global_bf2": ([_P] * 3 + [_I] * 5 + [_P] * 12 + [_I64, _I64, _F, _P], _I),
    "pf_global_ilv": ([_P] * 3 + [_I] * 5 + [_P] * 10 + [_I64, _I64, _F, _P], _I),
    "pf_global_fused": ([_P] * 4 + _SUB + _SUB + [_I, _I] + [_P] * 10
                        + [_I64, _I64, _F, _P], _I),
    "pf_destride": ([_P] * 4 + [_I] + [_I64] * 5 + [_P], _I),
    "pf_restride": ([_P] * 4 + [_I] + [_I64] * 6 + [_I, _P], _I),
    "pf_error_string": ([_I], ctypes.c_char_p),
}
#: The entry points that launch nothing: they answer a question.
_QUERIES = {"pf_error_string"} | {n for n in _SIGNATURES if n.endswith("_needs_scratch")}


class BuildError(RuntimeError):
    """``nvcc`` is missing or failed; the message holds its output."""


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    return None


def library_path() -> Path:
    return BUILD_DIR / f"libportfft_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the
    library's path.  Each ``.cu`` file is compiled by its own ``nvcc``, all
    started together, and the objects are linked into one shared library.
    Raises :class:`BuildError` with the compiler's output."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    if nvcc is None:
        raise BuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from portfft_tpu_torch/csrc at first use"
        )
    BUILD_DIR.mkdir(exist_ok=True)
    stem = f"{lib.stem}.{os.getpid()}"
    tmp = lib.with_name(f"{stem}.tmp.so")
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"nvcc exited with {proc.returncode}:\n{out}")
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc exited with {proc.returncode}:\n"
                          f"{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise BuildError("\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


def build_log() -> str:
    """The compiler's output of the current build ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point."""
    return declare(ctypes.CDLL(str(build())))


def declare(lib):
    """Give each entry point of ``lib`` its signature, and put each one that
    launches kernels inside a ``portfft.launch`` span while a profiler
    records; return ``lib``."""
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
        if name not in _QUERIES:
            setattr(lib, name, _spanned(name, fn))
    return lib


def _spanned(name: str, fn):
    def launch(*args):
        if PROFILER._is_profiler_enabled:
            return tracing.leaf(tracing.LAUNCH, fn, args, name)
        return fn(*args)

    launch.__name__ = name
    return launch


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err:
        msg = lib.pf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
