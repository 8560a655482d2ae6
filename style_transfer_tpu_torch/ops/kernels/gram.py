"""Streaming Gram matrix ``G = F^T F / M`` with a VJP to the activation.

Counterpart of ``style_transfer_tpu/ops/pallas/gram.py`` (``pallas_gram``,
``gram_matrix``, ``_PALLAS_CHANNELS``). Same contract: ``(N, H, W, C)``
activations -> ``(C, C)`` fp32 Gram normalized by ``M = N*H*W``; the VJP is
``dF = F (g + g^T) / M`` in the activation's dtype.

On a CUDA tensor both directions run on ``csrc/gram.cu`` (bf16 warpgroup MMA
fed by TMA): the forward sums partial tiles over each block's run of rows,
upper triangle only, and adds them in a fixed order in a second pass — the
kernel the chain's fused Grams use, here without a column window; the
backward is its ``F S`` kernel with ``S = (g + g^T) / M`` rounded to bf16, as
the chain's wrappers round it, and one bf16 rounding of the result. It takes
bf16 activations with C a multiple of 64 (every VGG width, and ResNet-50's
64-2048); another dtype raises, as the chain does. The TPU kernel's backward is outside its Pallas
kernel (a plain fp32 einsum); on the H100 the ``F S`` kernel takes half the
time of that fp32 product at every shape ``chip_smoke.py`` times (PERF.md).

On a CPU tensor it runs :func:`gram_plain` under autograd.

:func:`gram_matrix` dispatches by channel width through :data:`KERNEL_CHANNELS`,
read at call time; it is the counterpart of the reference's
``_PALLAS_CHANNELS`` and the tests patch both to the same widths. The set
holds every VGG width and ResNet-50's stage outputs' 1024 and 2048 (its
64, 256 and 512 are VGG's): on the H100 the kernel made the objective
step's device time shorter at each VGG width, at 1024, 512 and 256 px
(``chip_smoke.py``, phase ``objective``; the numbers are in PERF.md) — the
plain version casts the bf16 activation to fp32 and runs an fp32 product
outside the tensor cores — and ``chip_smoke.py``'s kernel phase times the
two wider ones at the 2048^2 ResNet cell's shapes (128^2 x 1024, 64^2 x
2048) against that plain contraction. On the host the two paths cost the same per call.
:data:`KERNEL_MIN_ELEMENTS` is the least activation size that goes to the
kernel; it is 0 since the tensor-core kernel has no floor worth a gate (it
was 2^23 while the kernel ran on the CUDA cores). On the TPU the set is empty
and there is no such gate.

Left out: the row-tile budget of the TPU kernel (``_tile_m``, ``_TILE_BYTES``)
and its zero padding of the rows to a tile multiple.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

#: Kernel launches made by :func:`pallas_gram` (forward and backward).
launches = LaunchCount("gram")

#: Channel widths that :func:`gram_matrix` sends to the kernel.
KERNEL_CHANNELS: frozenset = frozenset({64, 128, 256, 512, 1024, 2048})

#: Least size of the activation, in elements, at which it sends them there.
KERNEL_MIN_ELEMENTS: int = 0


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
        sym = ((g + g.T) / float(f.shape[0])).to(torch.bfloat16).contiguous()
        return _launch.gram_fs(f, sym, out_bf16=True, count=launches).view(ctx.shape)


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
