"""Typed launchers for the C entry points of the kernel library.

Each launcher checks device, dtype, shape, contiguity and alignment, allocates
every output (and scratch) with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch was refused, and adds one to the caller's
:class:`~style_transfer_tpu_torch.ops.kernels._build.LaunchCount`. Only CUDA
tensors get here; nothing in this module runs on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from style_transfer_tpu_torch.ops.kernels._build import LaunchCount, library


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_launch(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.st_error_string(err).decode()}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def conv3x3_fwd(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, count: LaunchCount,
    y: bool = False, mask: bool = False, pool: bool = False,
):
    """relu(conv3x3_same(x, w) + b) for x (H, W, K) bf16, w (3, 3, K, N) bf16,
    b (N,) bf16. Returns ``(y, mask, pool)``, None where not requested: the
    bf16 ReLU output (H, W, N), its int8 mask ``pre > 0`` (H, W, N), and its
    bf16 2x2 average pool (H/2, W/2, N)."""
    h, wd, k = x.shape
    n = w.shape[3]
    _require(x, "x", torch.bfloat16, (h, wd, k))
    _require(w, "w", torch.bfloat16, (3, 3, k, n))
    _require(b, "b", torch.bfloat16, (n,))
    if n % 4:
        raise ValueError(f"output channels must be a multiple of 4, got {n}")
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"pooling needs even H and W, got {(h, wd)}")
    out_y = torch.empty((h, wd, n), dtype=torch.bfloat16, device=x.device) if y else None
    out_m = torch.empty((h, wd, n), dtype=torch.int8, device=x.device) if mask else None
    out_p = (
        torch.empty((h // 2, wd // 2, n), dtype=torch.bfloat16, device=x.device)
        if pool else None
    )
    lib = library()
    err = lib.st_conv3x3_fwd(
        _ptr(x), _ptr(w), _ptr(b), _ptr(out_y), _ptr(out_m), _ptr(out_p),
        h, wd, k, n, _stream(),
    )
    _check_launch(lib, err, "conv3x3_fwd")
    count.n += 1
    return out_y, out_m, out_p


def taps_transposed(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO taps -> the backward-data operand (3, 3, Cout,
    Cin): spatially flipped, channels swapped, bf16, contiguous."""
    return w.flip(0, 1).transpose(2, 3).to(torch.bfloat16).contiguous()


def conv3x3_bwd_data(
    dy: torch.Tensor, w_t: torch.Tensor, *, hw: Tuple[int, int], count: LaunchCount,
    in_mask: Optional[torch.Tensor] = None, unpool: bool = False,
    add: Optional[torch.Tensor] = None, gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Transposed 3x3 SAME conv of a cotangent: (H, W, N) bf16 out of ``dy``
    (H, W, K) — or (H/2, W/2, K) when ``unpool`` — with ``w_t`` from
    :func:`taps_transposed`. Prologue: ``unpool`` (x0.25, duplicated rows and
    columns), then the int8 ``in_mask`` gate. Epilogue: ``+ add`` (fp32), then
    the ReLU gate ``gate > 0``, then the bf16 store."""
    h, wd = hw
    k, n = w_t.shape[2], w_t.shape[3]
    if unpool:
        if h % 2 or wd % 2:
            raise ValueError(f"unpooling needs even H and W, got {(h, wd)}")
        _require(dy, "dy", torch.bfloat16, (h // 2, wd // 2, k))
    else:
        _require(dy, "dy", torch.bfloat16, (h, wd, k))
    _require(w_t, "w_t", torch.bfloat16, (3, 3, k, n))
    if in_mask is not None:
        _require(in_mask, "in_mask", torch.int8, (h, wd, k))
    if add is not None:
        _require(add, "add", torch.float32, (h, wd, n))
    if gate is not None:
        _require(gate, "gate", torch.bfloat16, (h, wd, n))
    out = torch.empty((h, wd, n), dtype=torch.bfloat16, device=dy.device)
    lib = library()
    err = lib.st_conv3x3_bwd_data(
        _ptr(dy), _ptr(in_mask), int(unpool), _ptr(w_t), _ptr(add), _ptr(gate),
        _ptr(out), h, wd, k, n, _stream(),
    )
    _check_launch(lib, err, "conv3x3_bwd_data")
    count.n += 1
    return out


def gram(f: torch.Tensor, *, count: LaunchCount) -> torch.Tensor:
    """Unnormalized fp32 Gram ``F^T F`` of an (M, C) bf16 activation."""
    m, c = f.shape
    _require(f, "f", torch.bfloat16, (m, c))
    if c % 64:
        raise ValueError(f"Gram channels must be a multiple of 64, got {c}")
    lib = library()
    rows = lib.st_gram_rows_per_chunk()
    part = torch.empty((-(-m // rows), c, c), dtype=torch.float32, device=f.device)
    out = torch.empty((c, c), dtype=torch.float32, device=f.device)
    err = lib.st_gram(_ptr(f), _ptr(part), _ptr(out), m, c, _stream())
    _check_launch(lib, err, "gram")
    count.n += 1
    return out


def gram_fs(
    f: torch.Tensor, s: torch.Tensor, *, count: LaunchCount, relu_gate: bool = False
) -> torch.Tensor:
    """``F S`` for F (M, C) bf16 and S (C, C) bf16: fp32 (M, C), or with
    ``relu_gate`` the bf16 ``where(F > 0, F S, 0)``."""
    m, c = f.shape
    _require(f, "f", torch.bfloat16, (m, c))
    _require(s, "s", torch.bfloat16, (c, c))
    if c % 64:
        raise ValueError(f"Gram channels must be a multiple of 64, got {c}")
    out32 = None if relu_gate else torch.empty((m, c), dtype=torch.float32, device=f.device)
    out16 = torch.empty((m, c), dtype=torch.bfloat16, device=f.device) if relu_gate else None
    lib = library()
    err = lib.st_gram_fs(_ptr(f), _ptr(s), _ptr(out32), _ptr(out16), m, c, _stream())
    _check_launch(lib, err, "gram_fs")
    count.n += 1
    return out16 if relu_gate else out32


def tv_sse_grad(x2d: torch.Tensor, c: int, *, count: LaunchCount):
    """(H, W*C) fp32 image -> (sse (1,) fp32, raw gradient (H, W*C) fp32)."""
    h, wc = x2d.shape
    _require(x2d, "x", torch.float32, (h, wc))
    lib = library()
    partial = torch.empty((lib.st_tv_blocks(h, wc),), dtype=torch.float32, device=x2d.device)
    sse = torch.empty((1,), dtype=torch.float32, device=x2d.device)
    grad = torch.empty_like(x2d)
    err = lib.st_tv_sse_grad(_ptr(x2d), _ptr(grad), _ptr(partial), _ptr(sse), h, wc, c, _stream())
    _check_launch(lib, err, "tv_sse_grad")
    count.n += 1
    return sse, grad
