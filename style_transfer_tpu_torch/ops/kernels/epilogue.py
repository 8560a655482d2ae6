"""Fused objective epilogues: the TV loss + gradient, and the content and
style losses with their top-gradients.

Counterpart of ``style_transfer_tpu/ops/pallas/epilogue.py``:

- ``tv_loss``: the mean squared forward-difference TV of an NHWC image
  (N = 1) whose forward computes the loss AND its 5-point-stencil gradient in
  one pass, saving the gradient so the backward is a scale by the cotangent.
- ``content_loss(feat, target)``: ``mean((F - T)^2)`` in fp32; the forward
  computes the fp32 SSE and writes ``F - T`` in F's dtype in one pass (the
  difference is rounded after the sum took it), the backward is
  ``diff * 2 ct / numel``. The target gets no gradient.
- ``style_loss(gram, target_gram)``: the same for two (C, C) Grams, both cast
  to fp32 first.

On a CUDA tensor the TV pass is ``csrc/tv.cu`` and the two losses are
``csrc/epilogue.cu`` (per-block partial sums reduced in a fixed order, so a
loss is the same run to run); on a CPU tensor each runs its plain version,
the ``ops/losses.py`` oracle under autograd. On the card ``content_loss``
takes bf16 or fp32 activations, feature and target in the same dtype.

The content and style epilogues are opt-in, as in the reference: they are
hooks of ``ops.losses.objective_terms`` (``content_loss_fn``,
``style_loss_fn``) that ``api.StyleTransfer._loss_fns`` does not pass by
itself (PERF.md has their times in the step).

Left out: the 128-lane alignment gate of the TPU dispatch, the 8-row halo
blocks, the streamed row tiles (``_tile_rows``) and the mesh form
``make_sharded_tv_loss``.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

#: Kernel launches made by the TV wrapper.
launches = LaunchCount()
#: Kernel launches made by :func:`content_loss`.
content_launches = LaunchCount()
#: Kernel launches made by :func:`style_loss`.
style_launches = LaunchCount()


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


def content_loss_plain(feat, target):
    return losses.content_loss(feat, target)


def style_loss_plain(gram, target_gram):
    return losses.style_loss(gram, target_gram)


class _SseFunction(torch.autograd.Function):
    """``mean((a - b)^2)`` on ``csrc/epilogue.cu``: the forward saves the
    difference, the backward scales it. ``b`` gets no gradient."""

    @staticmethod
    def forward(ctx, a, b, count: LaunchCount):
        sse, diff = _launch.sse_diff(a.contiguous(), b.contiguous(), count=count)
        ctx.save_for_backward(diff)
        return sse[0] / float(a.numel())

    @staticmethod
    def backward(ctx, ct):
        (diff,) = ctx.saved_tensors
        scale = (2.0 * ct / float(diff.numel())).to(torch.float32)
        return (diff.to(torch.float32) * scale).to(diff.dtype), None, None


def content_loss(feat, target):
    """Drop-in for :func:`ops.losses.content_loss`: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if feat.shape != target.shape:
        raise ValueError(f"feature {tuple(feat.shape)} and target {tuple(target.shape)} differ")
    if feat.device.type == "cuda":
        return _SseFunction.apply(feat, target, content_launches)
    if feat.device.type == "cpu":
        return content_loss_plain(feat, target.detach())  # the target is a constant
    raise ValueError(f"content_loss runs on CUDA or CPU tensors, got device {feat.device}")


def style_loss(gram, target_gram):
    """Drop-in for :func:`ops.losses.style_loss`: the CUDA kernel for a CUDA
    tensor (both Grams cast to fp32 first), the plain version for a CPU
    tensor."""
    if gram.shape != target_gram.shape:
        raise ValueError(f"Gram {tuple(gram.shape)} and target {tuple(target_gram.shape)} differ")
    if gram.device.type == "cuda":
        return _SseFunction.apply(
            gram.to(torch.float32), target_gram.to(torch.float32), style_launches
        )
    if gram.device.type == "cpu":
        return style_loss_plain(gram, target_gram.detach())
    raise ValueError(f"style_loss runs on CUDA or CPU tensors, got device {gram.device}")
