"""Build the CUDA kernels (``csrc/*.cu``) with ``nvcc`` and load them with
``ctypes``.

The library is compiled for Hopper (``sm_90a``) at first use on a CUDA
device, into ``portfft_tpu_torch/_build/`` (listed in ``.gitignore``).  Its
file name carries a hash of the sources and flags, so a stale build is never
loaded.  Each C entry point takes raw device pointers and the caller's CUDA
stream, allocates nothing, and returns ``cudaGetLastError()`` after its
launches; :func:`check` raises when that code is not 0.  Importing this
module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SUB = [_I, _I, _P, _P, _P, _P, _P, _P]  # m, a, wr, wi, br, bi, ur, ui
_SIGNATURES = {
    "pf_direct": ([_P, _P, _P, _P, _I64, _I, _F, _P], _I),
    "pf_fused2_needs_scratch": ([_I], _I),
    "pf_fused2": ([_P] * 9 + [_I64, _I, _F, _P], _I),
    "pf_global2": ([_P, _P, _P] + _SUB + _SUB + [_P, _P, _I64, _F, _P], _I),
    "pf_untangle": ([_P, _P, _P, _P, _I64, _I, _F, _P], _I),
    "pf_retangle": ([_P, _P, _P, _P, _I64, _I, _F, _P], _I),
    "pf_small_real": ([_P, _P, _P, _P, _I64, _I, _I, _F, _P], _I),
    "pf_col_needs_scratch": ([_I], _I),
    "pf_col": ([_P, _P, _P] + _SUB + [_I64, _I64, _F, _P], _I),
    "pf_md2": ([_P, _P] + _SUB + _SUB + [_I64, _F, _P], _I),
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
    "pf_bluestein": ([_P] * 6 + [_I64] + _SUB * 4 + [_P] * 10 + [_I64, _F, _P], _I),
    "pf_error_string": ([_I], ctypes.c_char_p),
}


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
    library's path.  Raises :class:`BuildError` with the compiler's output."""
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
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in _sources() if s.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc exited with {proc.returncode}:\n{output}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


def build_log() -> str:
    """The compiler's output of the current build ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err:
        msg = lib.pf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
