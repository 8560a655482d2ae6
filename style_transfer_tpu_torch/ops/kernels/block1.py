"""Fused VGG block 1: conv1_1 + ReLU + conv1_2 + ReLU + 2x2 average pool,
plus the conv1_1 Gram, with a VJP to the preprocessed image.

Counterpart of ``style_transfer_tpu/ops/pallas/block1_packed.py::
block1_packed`` (and of ``block1.py::block1_full``, which has the same
contract). Contract: ``(x, k1, b1, k2, b2) -> (pool1 (1, H/2, W/2, 64),
gram (64, 64) fp32 / (H*W))`` for the preprocessed image ``x`` (1, H, W, 3),
H and W even; the backward writes the image cotangent.

This is exactly the conv pair with Cin=3, Cmid=64 and both epilogues, so on
a CUDA tensor it runs the same kernels (``csrc/conv3x3.cu``, ``csrc/gram.cu``)
through :class:`~style_transfer_tpu_torch.ops.kernels.conv_pair.PairFunction`
with its own launch counter; conv1_1's 3-channel reduction takes the
kernel's scalar staging path. On a CPU tensor it runs :func:`block1_plain`.

Left out from the TPU kernel: the W-pair lane packing (two pixels per
128-lane register — a TPU layout device), the packed im2col of conv1_1, the
``vmem.py`` envelope, and the mesh form ``make_sharded_block1``.
"""

from __future__ import annotations

from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

C = 64

#: Kernel launches made by the block-1 wrapper.
launches = LaunchCount()


def block1_plain(x, k1, b1, k2, b2):
    """Block 1 in plain PyTorch ops (autograd gives the VJP)."""
    return CP.conv_pair_plain(x, k1, b1, k2, b2, pool=True, gram=True)


def block1_packed(x, k1, b1, k2, b2):
    """Whole VGG block 1 fused; see the module docstring."""
    n, h, w, c = x.shape
    if n != 1 or c != 3 or h % 2 or w % 2:
        raise ValueError("block1_packed expects (1, even H, even W, 3)")
    if x.device.type == "cuda":
        return CP.PairFunction.apply(x, k1, b1, k2, b2, True, True, launches)
    if x.device.type == "cpu":
        return block1_plain(x, k1, b1, k2, b2)
    raise ValueError(f"block1_packed runs on CUDA or CPU tensors, got device {x.device}")
