"""Build and load the hand-written Hopper kernels (``style_transfer_tpu_torch/csrc``).

The CUDA sources have a plain C interface, so they are compiled with ``nvcc``
straight into one shared library and loaded with :mod:`ctypes` — no PyTorch
headers, which keeps the build to seconds. The build runs once, at the first
kernel launch, into ``style_transfer_tpu_torch/_build/`` (git-ignored); the
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

There is no fallback: where ``nvcc`` or a CUDA device is missing,
:func:`library` raises :class:`KernelBuildError`. The kernel wrappers call it
only for CUDA tensors, so a CUDA tensor never silently reaches a plain
PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns a CUDA error code)
_SIGNATURES = {
    "st_conv3x3_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "st_conv3x3_bwd_data": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "st_gram": [_P, _P, _P, _I, _I, _P],
    "st_gram_fs": [_P, _P, _P, _P, _I, _I, _P],
    "st_gram_rows_per_chunk": [],
    "st_tv_sse_grad": [_P, _P, _P, _P, _I, _I, _I, _P],
    "st_tv_blocks": [_I, _I],
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels cannot be built or loaded on this machine."""


class LaunchCount:
    """Plain-integer count of a wrapper's kernel launches (reset by setting
    ``n = 0``). A run reads it to show that its main path went through the
    kernel rather than the plain version."""

    def __init__(self) -> None:
        self.n = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of style_transfer_tpu_torch need the CUDA toolkit to build"
    )


def _sources() -> list:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libst_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources if the hashed library is missing; returns its path.
    The compiler's register/shared-memory report goes to ``<lib>.log``."""
    target = library_path()
    if target.is_file():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, target)  # atomic: a concurrent build never sees a partial file
    return target


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises
    :class:`KernelBuildError` without a CUDA device or ``nvcc``."""
    if not torch.cuda.is_available():
        raise KernelBuildError(
            "CUDA is not available: the style_transfer_tpu_torch kernels run "
            "only on an NVIDIA GPU (CPU tensors take the plain PyTorch versions)"
        )
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.st_error_string.argtypes = [ctypes.c_int]
    lib.st_error_string.restype = ctypes.c_char_p
    return lib

