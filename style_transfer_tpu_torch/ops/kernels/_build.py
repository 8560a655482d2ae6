"""Build and load the hand-written Hopper kernels (``style_transfer_tpu_torch/csrc``).

The CUDA sources have a plain C interface, so they are compiled with ``nvcc``
into one shared library and loaded with :mod:`ctypes` — no PyTorch headers,
which keeps the build to seconds. Each source compiles in its own ``nvcc``
process, all started together, and one more links the objects. The build
runs once, at the first kernel launch, into ``style_transfer_tpu_torch/
_build/`` (git-ignored); the library's file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.

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

from style_transfer_tpu_torch import trace

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (every one returns a CUDA error code)
_SIGNATURES = {
    "st_conv3x3_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "st_conv3x3_bwd_data": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "st_conv3x3_tile_info": [_I, ctypes.POINTER(ctypes.c_int)],
    "st_gram": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "st_gram_fs": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "st_gram_info": [ctypes.POINTER(ctypes.c_int)],
    "st_tv": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "st_tv_grad": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "st_tv_info": [ctypes.POINTER(ctypes.c_int)],
    "st_sse": [_P, _P, _P, _P, _P, _L, _F, _I, _I, _P],
    "st_scale_cast": [_P, _P, _P, _P, _L, _F, _I, _I, _P],
    "st_sse_info": [ctypes.POINTER(ctypes.c_int)],
    "st_noop": [_P],
    "st_block1_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "st_block1_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "st_block1_partials": [_I, _I],
    "st_block1_info": [ctypes.POINTER(ctypes.c_int)],
    "st_block1_col2im": [_P, _P, _I, _I, _P],
    "st_conv1x1": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "st_conv1x1_info": [_I, ctypes.POINTER(ctypes.c_int)],
    "st_im2col": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "st_col2im": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "st_maxpool_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "st_maxpool_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "st_relu_gate": [_P, _P, _P, _L, _P],
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels cannot be built or loaded on this machine."""


class LaunchCount:
    """Plain-integer count of a wrapper's kernel launches (reset by setting
    ``n = 0``). A run reads it to show that its main path went through the
    kernel rather than the plain version.

    Each launch calls :meth:`add`, which adds one to ``n`` always and, while
    :mod:`style_transfer_tpu_torch.trace` records (a profiler session or a
    ``trace.recording()`` block), one to ``trace.counts()[(name, kernel,
    shape)]``: ``name`` the wrapper's (``conv_pair``, ``gram`` ...),
    ``kernel`` the launcher of ``_launch.py`` (``conv3x3_fwd`` ...) and
    ``shape`` the sizes and flags its operations and bytes follow from (the
    launcher's docstring)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.n = 0

    def add(self, kernel: str, shape: tuple) -> None:
        self.n += 1
        if trace.active():
            trace.count(self.name, kernel, shape)


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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libst_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources if the hashed library is missing; returns its path.
    One ``nvcc`` per source, all running at once, then one link. The
    compilers' register/shared-memory reports go to ``<lib>.log``."""
    target = library_path()
    if target.is_file():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-4000:]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise KernelBuildError("nvcc failed: " + "\n".join(failed))
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp, target)  # atomic: a concurrent build never sees a partial file
    finally:
        target.with_suffix(".log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
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

