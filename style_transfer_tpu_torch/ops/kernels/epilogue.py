"""Fused TV loss + gradient.

Counterpart of ``style_transfer_tpu/ops/pallas/epilogue.py::tv_loss``: the
mean squared forward-difference TV of an NHWC image (N = 1) whose forward
computes the loss AND its 5-point-stencil gradient in one pass, saving the
gradient so the backward is a scale by the cotangent.

On a CUDA tensor the pass is ``csrc/tv.cu`` (per-block partial sums reduced
in a fixed order); on a CPU tensor it is :func:`tv_loss_plain`, the
``ops/losses.py`` oracle under autograd.

Left out: the 128-lane alignment gate of the TPU dispatch, the 8-row halo
blocks, and the mesh form ``make_sharded_tv_loss``. The fused content and
style epilogues of the same TPU module are not on the default path and are
not ported yet.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

#: Kernel launches made by the TV wrapper.
launches = LaunchCount()


def tv_loss_plain(image):
    return losses.tv_loss(image)


class TVFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image):
        n, h, w, c = image.shape
        if n != 1:
            raise ValueError("fused tv_loss expects a single NHWC image (N=1)")
        x2d = image.to(torch.float32).reshape(h, w * c).contiguous()
        sse, grad = _launch.tv_sse_grad(x2d, c, count=launches)
        ctx.save_for_backward(grad.view(image.shape).to(image.dtype))
        return sse[0] / float(image.numel())

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return grad * (ct / float(grad.numel()))


def tv_loss(image):
    """Drop-in for :func:`ops.losses.tv_loss`: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if image.device.type == "cuda":
        return TVFunction.apply(image)
    if image.device.type == "cpu":
        return tv_loss_plain(image)
    raise ValueError(f"tv_loss runs on CUDA or CPU tensors, got device {image.device}")
