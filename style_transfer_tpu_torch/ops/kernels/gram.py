"""Streaming Gram matrix ``G = F^T F / M`` with a VJP to the activation.

Counterpart of ``style_transfer_tpu/ops/pallas/gram.py`` (``pallas_gram``,
``gram_matrix``, ``_PALLAS_CHANNELS``). Same contract: ``(N, H, W, C)``
activations -> ``(C, C)`` fp32 Gram normalized by ``M = N*H*W``; the VJP is
``dF = F (g + g^T) / M`` in the activation's dtype.

On a CUDA tensor the forward is ``csrc/gram.cu`` — per-block partial sums over
chunks of rows, added in a fixed order by a second pass — the kernel the
chain's fused Grams use, here without a column window. It takes bf16
activations with C a multiple of 64 (every VGG width); another dtype raises,
as the chain does. The TPU kernel's backward is outside its Pallas kernel (a
plain fp32 einsum), so here it is a plain fp32 ``torch.matmul`` too. The
``F S`` kernel of ``csrc/gram.cu`` (``_launch.gram_fs``, S rounded to bf16)
computes the same product; ``chip_smoke.py`` times both and PERF.md has the
numbers: the matmul is faster at C = 256 and 512, ``gram_fs`` at 64 and 128.

On a CPU tensor it runs :func:`gram_plain` under autograd.

:func:`gram_matrix` dispatches by channel width through :data:`KERNEL_CHANNELS`,
read at call time; it is the counterpart of the reference's
``_PALLAS_CHANNELS`` and the tests patch both to the same widths. The widths
in it are those where the kernel made the 1024 px objective step faster on
the H100 than the plain fp32 contraction, by more than the rounds of one
setting spread (``chip_smoke.py``, phase ``objective``; the numbers are in
PERF.md): the plain version casts the bf16 activation to fp32 and runs an fp32
product outside the tensor cores, which the kernel's bf16 reads undercut.
C = 512 is left out: its two shapes won nothing that the step's device or
wall time could show. The kernel's time has a floor of about 0.14 ms (forward
and backward), so below :data:`KERNEL_MIN_ELEMENTS` (8.4 M elements, 16 MiB of
bf16: every layer of a 256 px image, conv3_1 of a 512 px one) the plain
contraction is as fast or faster and keeps the activation. On the TPU the set
is empty and there is no such gate.

Left out: the row-tile budget of the TPU kernel (``_tile_m``, ``_TILE_BYTES``)
and its zero padding of the rows to a tile multiple.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

#: Kernel launches made by :func:`pallas_gram` (its forward).
launches = LaunchCount()

#: Channel widths that :func:`gram_matrix` sends to the kernel.
KERNEL_CHANNELS: frozenset = frozenset({64, 128, 256})

#: Least size of the activation, in elements, at which it sends them there.
KERNEL_MIN_ELEMENTS: int = 1 << 23


def gram_plain(feat):
    return losses.gram_matrix(feat)


class GramFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat):
        if feat.dtype != torch.bfloat16:
            raise ValueError(f"the Gram kernel takes bf16 activations, got {feat.dtype}")
        c = feat.shape[-1]
        f = feat.reshape(-1, c).contiguous()
        ctx.save_for_backward(f)
        ctx.shape = feat.shape
        return _launch.gram(f, count=launches) / float(f.shape[0])

    @staticmethod
    def backward(ctx, g):
        (f,) = ctx.saved_tensors
        sym = (g + g.T) / float(f.shape[0])
        return (f.to(torch.float32) @ sym).to(f.dtype).view(ctx.shape)


def pallas_gram(feat):
    """The streaming-kernel Gram: (N, H, W, C) -> (C, C) fp32 / (N*H*W); the
    CUDA kernel for a CUDA tensor, :func:`gram_plain` for a CPU tensor."""
    if feat.ndim != 4:
        raise ValueError(f"expected (N, H, W, C) activations, got {tuple(feat.shape)}")
    if feat.device.type == "cuda":
        return GramFunction.apply(feat)
    if feat.device.type == "cpu":
        return gram_plain(feat)
    raise ValueError(f"pallas_gram runs on CUDA or CPU tensors, got device {feat.device}")


def gram_matrix(feat):
    """Drop-in for :func:`ops.losses.gram_matrix`: :func:`pallas_gram` for the
    channel widths in :data:`KERNEL_CHANNELS` on activations of at least
    :data:`KERNEL_MIN_ELEMENTS` elements, the plain contraction for the rest."""
    if feat.shape[-1] in KERNEL_CHANNELS and feat.numel() >= KERNEL_MIN_ELEMENTS:
        return pallas_gram(feat)
    return losses.gram_matrix(feat)
