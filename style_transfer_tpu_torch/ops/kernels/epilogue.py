"""Fused objective epilogues: the TV loss, and the content and style losses,
each one kernel launch forward and one backward.

Counterpart of ``style_transfer_tpu/ops/pallas/epilogue.py``:

- ``tv_loss``: the mean squared forward-difference TV of an NHWC image
  (N = 1, fp32) and its 5-point-stencil gradient times ``ct / numel``.
- ``content_loss(feat, target)``: ``mean((F - T)^2)`` in fp32, summed from
  the unrounded fp32 difference; the gradient is ``F - T`` rounded once to
  F's dtype, times ``2 ct / numel`` in fp32, rounded once more: the
  reference's chain bit for bit. The target gets no gradient.
- ``style_loss(gram, target_gram)``: the same for two (C, C) Grams, cast to
  fp32 where they are not fp32 already.

On a CUDA tensor the TV passes are ``csrc/tv.cu`` and the two losses are
``csrc/epilogue.cu``; on a CPU tensor each runs its plain version, the
``ops/losses.py`` oracle under autograd. On the card ``content_loss`` takes
bf16 or fp32 activations, feature and target in the same dtype.

What bounds them on the H100, and what the wrappers do about it. These are
streaming passes: bytes at the large shapes (conv4_2 at 1024 px is 16.8 MB in
bf16, a 512 x 8192 image 50 MB), launches at the small ones (a 64 x 64 Gram
is 16 KB; a 512 x 512 image sits in L2). So a call is exactly two launches
with no PyTorch op between the caller's tensors and the kernels: the forward
kernel finishes its own cross-block sum and writes the mean as the 0-d tensor
that is returned (fixed order: the same bits run to run), and the backward
kernel reads the cotangent on the device, never on the host. Under autograd
the cotangent is unknown in the forward, so the least traffic is two passes.
The reference's forward also writes the difference (the raw TV gradient) for
its backward to scale; here the forward only reads, and the backward forms
the difference (the stencil) again from the inputs, which the optimizer step
holds anyway: the same bytes for the losses but no buffer kept between the
passes, and three passes over the image instead of four for TV. The bits are
the same; the stored form was measured beside this one and was never faster
(PERF.md).

The content and style epilogues are opt-in, as in the reference: they are
hooks of ``ops.losses.objective_terms`` (``content_loss_fn``,
``style_loss_fn``) that ``api.StyleTransfer._loss_fns`` does not pass by
itself (PERF.md has their times in the step).

The mesh form ``make_sharded_tv_loss`` runs the TV kernels per shard with
the divisor 1 (``tv_sse``) and adds the boundary rows' differences in plain
torch.

Left out: the 128-lane alignment gate of the TPU dispatch, the 8-row halo
blocks and the streamed row tiles (``_tile_rows``); the mesh form's gate
(H divisible by the device count): shards are cut by ``mesh.row_bounds``.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.parallel import mesh as M

#: Kernel launches made by the TV wrapper, forward and backward.
launches = LaunchCount("tv")
#: Kernel launches made by :func:`content_loss`, forward and backward.
content_launches = LaunchCount("content_loss")
#: Kernel launches made by :func:`style_loss`, forward and backward.
style_launches = LaunchCount("style_loss")

def tv_loss_plain(image):
    return losses.tv_loss(image)


def scale_cast_plain(diff, ct, numel: int, mult: float = 2.0):
    """``diff * ((mult * ct) / numel)``: read in its dtype, multiplied in
    fp32, rounded once to its dtype — the backward chain of the reference's
    losses (``mult`` 2) and of its TV (``mult`` 1). The scale is a true fp32
    division of two tensors (a division by a Python number may become a
    multiplication by its reciprocal, which differs in the last bit)."""
    count = torch.tensor(float(numel), dtype=torch.float32, device=diff.device)
    scale = torch.div(mult * ct.to(device=diff.device, dtype=torch.float32), count)
    return (diff.to(torch.float32) * scale).to(diff.dtype)


def sse_backward_plain(ct, a, b):
    """The gradient of ``mean((a - b)^2)`` to ``a`` for the cotangent ``ct``,
    as the reference forms it (the difference rounded once to the dtype, then
    its chain): the plain version of the ``scale_cast`` kernel, which has the
    same bits."""
    diff = (a.to(torch.float32) - b.to(torch.float32)).to(a.dtype)
    return scale_cast_plain(diff, ct, diff.numel())


def tv_grad_plain(x2d, c: int):
    """The gradient of the TV sum of an (H, W*C) image: ``2 (dh[r-1] - dh[r]
    + dw[q-C] - dw[q])`` with zero differences out of the last row and the
    last pixel column, in the order the reference's kernel writes it."""
    dh, dw = torch.zeros_like(x2d), torch.zeros_like(x2d)
    dh[:-1] = x2d[1:] - x2d[:-1]
    dw[:, :-c] = x2d[:, c:] - x2d[:, :-c]
    dh_prev, dw_prev = torch.zeros_like(x2d), torch.zeros_like(x2d)
    dh_prev[1:] = dh[:-1]
    dw_prev[:, c:] = dw[:, :-c]
    return 2.0 * (dh_prev - dh + dw_prev - dw)


def tv_backward_plain(image, ct):
    """The gradient of :func:`tv_loss_plain` for the cotangent ``ct``, as the
    reference forms it: the plain version of the TV backward kernel, which
    has the same bits."""
    _, h, w, c = image.shape
    grad = tv_grad_plain(image.to(torch.float32).reshape(h, w * c), c)
    return scale_cast_plain(grad.view(image.shape).to(image.dtype), ct, image.numel(), mult=1.0)


class TVFunction(torch.autograd.Function):
    """The TV kernels: ``apply(image, numel)`` is the sum of the squared
    forward differences divided by ``numel`` (None: the image's element
    count, the mean; 1.0: the sum itself), one launch each way."""

    @staticmethod
    def forward(ctx, image, numel=None):
        n, h, w, c = image.shape
        if n != 1:
            raise ValueError("fused tv_loss expects a single NHWC image (N=1)")
        x2d = image.to(torch.float32).reshape(h, w * c).contiguous()
        ctx.save_for_backward(x2d)
        ctx.image = (image.shape, image.dtype)
        ctx.numel = numel
        return _launch.tv(x2d, c, count=launches, numel=numel)

    @staticmethod
    def backward(ctx, ct):
        (x2d,) = ctx.saved_tensors
        shape, dtype = ctx.image
        grad = _launch.tv_grad(x2d, shape[3], _launch.cotangent(ct, x2d.device), count=launches,
                               numel=ctx.numel)
        return grad.view(shape).to(dtype), None


def tv_loss(image):
    """Drop-in for :func:`ops.losses.tv_loss`: the CUDA kernels for a CUDA
    tensor, the plain version for a CPU tensor."""
    if image.device.type == "cuda":
        return TVFunction.apply(image, None)
    if image.device.type == "cpu":
        return tv_loss_plain(image)
    raise ValueError(f"tv_loss runs on CUDA or CPU tensors, got device {image.device}")


def tv_sse(image):
    """The TV sum (:func:`ops.losses.tv_sse`): the CUDA kernels with the
    divisor 1 for a CUDA tensor, the plain version for a CPU tensor."""
    if image.device.type == "cuda":
        return TVFunction.apply(image, 1.0)
    if image.device.type == "cpu":
        return losses.tv_sse(image)
    raise ValueError(f"tv_sse runs on CUDA or CPU tensors, got device {image.device}")


def make_sharded_tv_loss(mesh, *, fused: bool = True):
    """:func:`tv_loss` on a 1-D spatial mesh (JAX ``make_sharded_tv_loss``,
    ``epilogue.py:380``): ``f(shards)`` takes an NHWC image as the list of
    its H shards, shard ``i`` on its own device, and returns the 0-d loss
    on ``mesh.home``. Each shard runs the TV kernels on its own rows as a
    whole image (:func:`tv_sse`: one launch forward, one backward; on a CPU
    shard the plain version), which leaves out the one forward difference
    across each boundary; that one is added in plain torch from a one-row
    halo, the next shard's first row copied to this shard's device, as the
    JAX body adds it from its ``ppermute`` rows (``:356-376``). The partial
    sums are added on the home device in shard order
    (``parallel.mesh.all_reduce_to``) and divided by the global element
    count. Autograd keeps the gradient per shard: each shard's kernel
    gradient, plus the boundary row's term on the two shards it joins. One
    shard is :func:`tv_loss` itself. ``fused=False`` takes the plain
    ``ops.losses`` sums on every device (the plain path's TV)."""
    home = mesh.home
    one = tv_loss if fused else losses.tv_loss
    part = tv_sse if fused else losses.tv_sse

    def sharded_tv_loss(shards):
        shards = list(shards)
        if len(shards) == 1:
            return one(shards[0])
        parts = []
        for i, x in enumerate(shards):
            sse = part(x)
            if i + 1 < len(shards):
                down = shards[i + 1][:, :1].to(x.device, non_blocking=True)
                dh = down.to(torch.float32) - x[:, -1:].to(torch.float32)
                sse = sse + torch.sum(dh * dh)
            parts.append(sse)
        return M.all_reduce_to(parts, home) / float(sum(x.numel() for x in shards))

    return sharded_tv_loss


def content_loss_plain(feat, target):
    return losses.content_loss(feat, target)


def style_loss_plain(gram, target_gram):
    return losses.style_loss(gram, target_gram)


class _SseFunction(torch.autograd.Function):
    """``mean((a - b)^2)`` on ``csrc/epilogue.cu``: one launch forward, one
    backward (:func:`sse_backward_plain` is its plain version). ``b`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, a, b, count: LaunchCount):
        a, b = a.contiguous(), b.contiguous()
        ctx.save_for_backward(a, b)
        ctx.count = count
        return _launch.sse(a, b, count=count)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        grad = _launch.scale_cast(a, b, _launch.cotangent(ct, a.device), count=ctx.count)
        return grad, None, None


def content_loss(feat, target):
    """Drop-in for :func:`ops.losses.content_loss`: the CUDA kernels for a
    CUDA tensor, the plain version for a CPU tensor."""
    if feat.shape != target.shape:
        raise ValueError(f"feature {tuple(feat.shape)} and target {tuple(target.shape)} differ")
    if feat.device.type == "cuda":
        return _SseFunction.apply(feat, target, content_launches)
    if feat.device.type == "cpu":
        return content_loss_plain(feat, target.detach())  # the target is a constant
    raise ValueError(f"content_loss runs on CUDA or CPU tensors, got device {feat.device}")


def style_loss(gram, target_gram):
    """Drop-in for :func:`ops.losses.style_loss`: the CUDA kernels for a CUDA
    tensor (a Gram that is not fp32 is cast first), the plain version for a
    CPU tensor."""
    if gram.shape != target_gram.shape:
        raise ValueError(f"Gram {tuple(gram.shape)} and target {tuple(target_gram.shape)} differ")
    if gram.device.type == "cuda":
        return _SseFunction.apply(
            gram.to(torch.float32), target_gram.to(torch.float32), style_launches
        )
    if gram.device.type == "cpu":
        return style_loss_plain(gram, target_gram.detach())
    raise ValueError(f"style_loss runs on CUDA or CPU tensors, got device {gram.device}")
