"""Fused conv pair: two 3x3 convs (+ReLUs), optional 2x2 average pool and
optional Gram of the first activation, with a VJP to the input.

Counterpart of ``style_transfer_tpu/ops/pallas/conv_pair.py``
(``make_conv_pair``, ``pair_gram``, ``pair_pool``). Same contract:
``(x, k1, b1, k2, b2) -> out`` or ``(out, gram)``, ``x`` (1, H, W, Cin),
``out`` the pooled (1, H/2, W/2, Cmid) or full (1, H, W, Cmid) second
activation, ``gram`` the FIRST activation's (Cmid, Cmid) fp32 Gram / (H*W);
the backward differentiates w.r.t. the input only. The VGG weights are
frozen: their gradients are ``None`` on both devices, the PyTorch form of
the reference's structural zeros (``tests/test_weight_grads.py``).

On a CUDA tensor the pair runs on the hand-written kernels of
``csrc/conv3x3.cu`` and ``csrc/gram.cu``:

- forward: conv a -> r1 (bf16, saved); conv b -> int8 ReLU mask (saved) and
  the pooled or full output; Gram of r1 (partials + ordered reduce);
- backward: ``S = (dG + dG^T) / (H*W)``; ``r1 S`` (fp32, when the Gram is
  used); launch 1 = transposed conv b with the unpool/mask prologue and the
  ``+ r1 S`` / ``r1 > 0`` epilogue -> dpre1 (bf16); launch 2 = transposed
  conv a -> dx (bf16). The saved tensors are the TPU kernel's (r1 + mask).

On a CPU tensor it runs :func:`conv_pair_plain` (``F.conv2d``, the port's
pool and Gram) under autograd, on detached weights (``_weights.frozen``).
Any other device raises.

Two optional arguments serve the mesh: ``gram_rows = (lo, hi)`` takes the
Gram over rows ``[lo, hi)`` of the first activation only (a shard's own
rows, without its halo), and ``hw`` is its divisor, the whole image's H*W in
place of the call's own; the backward's ``S`` takes the same divisor and its
``r1 S`` term is zero outside the rows. The rows are a contiguous span of
r1, so the Gram kernels run on that span (``_launch.gram(rows=)`` /
``gram_fs(rows=)``, which zeroes the halo rows of ``r1 S`` around it).
:func:`make_sharded_pair` is the mesh form (JAX ``make_sharded_pair``,
``conv_pair.py:519``): each shard's rows plus :data:`HALO` rows of its
neighbours through the pair, its own output rows kept, the Grams summed on
the mesh's home device (``parallel/mesh.py``).

Left out from the TPU kernel: the sublane tiling (``_tile_for``), W-chunking
(``_w_chunks``), the row padding to a tile multiple, the ``vmem.py`` gates,
and the global row offset ``off`` with its row masks (an edge shard here has
no halo rows, so the kernel's own zero padding is the image's).
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch, _weights
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.parallel import mesh as M

#: Kernel launches made by the conv-pair wrapper (and its block-2 instance).
launches = LaunchCount("conv_pair")

#: Halo rows each way of a shard under :func:`make_sharded_pair`: the
#: pair's reach (two 3x3 convs), even for the pool's row pairs. The TPU's
#: 4 (``conv_pair.py:460``) also covers its clamped edge blocks.
HALO = 2


def conv_pair_plain(x, k1, b1, k2, b2, *, pool: bool, gram: bool, gram_rows=None, hw=None):
    """The pair in plain PyTorch ops (autograd gives the VJP)."""
    r1 = torch.relu(vgg.conv3x3(x, k1, b1))
    y2 = torch.relu(vgg.conv3x3(r1, k2, b2))
    out = vgg.pool2x2(y2, "average") if pool else y2
    return (out, losses.gram_matrix(r1, rows=gram_rows, hw=hw)) if gram else out


def _rows(gram_rows, w: int):
    """``_launch``'s ``rows = (W, lo, hi)`` for a ``gram_rows`` window."""
    return None if gram_rows is None else (w, *gram_rows)


class PairFunction(torch.autograd.Function):
    """The pair on the CUDA kernels; ``count`` receives the launches."""

    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2, pool: bool, gram: bool, count: LaunchCount,
                gram_rows=None, hw=None):
        n, h, w, _ = x.shape
        if n != 1 or (pool and (h % 2 or w % 2)):
            raise ValueError(f"conv pair expects (1, even H, even W, C), got {tuple(x.shape)}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the conv-pair kernel takes bf16 input, got {x.dtype}")
        r1, _, _ = _launch.conv3x3_fwd(
            x[0].contiguous(), _launch.taps(k1), _launch.taps(b1),
            y=True, count=count,
        )
        y2, mask2, pooled = _launch.conv3x3_fwd(
            r1, _launch.taps(k2), _launch.taps(b2),
            y=not pool, mask=True, pool=pool, count=count,
        )
        out = pooled if pool else y2
        ctx.save_for_backward(r1, mask2, k1, k2)
        ctx.pool, ctx.gram, ctx.count = pool, gram, count
        ctx.rows, ctx.hw = _rows(gram_rows, w), float(h * w if hw is None else hw)
        if gram:
            cmid = r1.shape[2]
            g = _launch.gram(r1.view(h * w, cmid), rows=ctx.rows, count=count) / ctx.hw
            return out[None], g
        return out[None]

    @staticmethod
    def backward(ctx, d_out, d_gram=None):
        r1, mask2, k1, k2 = ctx.saved_tensors
        h, w, cmid = r1.shape
        count = ctx.count
        add = None
        if ctx.gram:
            s = ((d_gram + d_gram.T) / ctx.hw).to(torch.bfloat16).contiguous()
            add = _launch.gram_fs(r1.view(h * w, cmid), s, rows=ctx.rows,
                                  count=count).view(h, w, cmid)
        dpre1 = _launch.conv3x3_bwd_data(
            d_out[0].to(torch.bfloat16).contiguous(), _launch.taps_transposed(k2),
            hw=(h, w), in_mask=mask2, unpool=ctx.pool, add=add, gate=r1, count=count,
        )
        dx = _launch.conv3x3_bwd_data(
            dpre1, _launch.taps_transposed(k1), hw=(h, w), count=count
        )
        return dx[None], None, None, None, None, None, None, None, None, None


def conv_pair(x, k1, b1, k2, b2, *, pool: bool, gram: bool, gram_rows=None, hw=None):
    """The fused pair: CUDA kernels for a CUDA tensor, :func:`conv_pair_plain`
    for a CPU tensor. Differentiates w.r.t. ``x`` only: the frozen weights'
    gradients are ``None`` on both devices."""
    if x.device.type == "cuda":
        return PairFunction.apply(x, k1, b1, k2, b2, pool, gram, launches, gram_rows, hw)
    if x.device.type == "cpu":
        return conv_pair_plain(x, *_weights.frozen(k1, b1, k2, b2), pool=pool, gram=gram,
                               gram_rows=gram_rows, hw=hw)
    raise ValueError(f"conv_pair runs on CUDA or CPU tensors, got device {x.device}")


def pair_gram(x, k1, b1, k2, b2):
    """Block-3/4 front pair: two convs with the first conv's Gram."""
    return conv_pair(x, k1, b1, k2, b2, pool=False, gram=True)


def pair_pool(x, k1, b1, k2, b2):
    """Block-3/4 tail pair: two convs and the 2x2 average pool."""
    return conv_pair(x, k1, b1, k2, b2, pool=True, gram=False)


def make_conv_pair(*, pool: bool, gram: bool):
    """``f(x, k1, b1, k2, b2)``: :func:`conv_pair` with the given epilogues
    (JAX ``make_conv_pair``, ``conv_pair.py:395``). It differentiates w.r.t.
    ``x`` only; the frozen weights' gradients are ``None``."""

    def pair(x, k1, b1, k2, b2):
        return conv_pair(x, k1, b1, k2, b2, pool=pool, gram=gram)

    return pair


def make_sharded_pair(mesh, *, pool: bool, gram: bool):
    """:func:`conv_pair` on a 1-D spatial mesh (JAX ``make_sharded_pair``):
    ``f(xs, k1, b1, k2, b2)`` takes the input as a list of H shards, one per
    mesh device, and returns the output as such a list (and the Gram on the
    mesh's home device). Each shard runs the pair on its rows plus
    :data:`HALO` rows of each neighbour (``parallel.mesh.with_halo``), keeps
    its own output rows, and takes the Gram over its own rows of the first
    activation with the global H*W; the Grams are summed on the home device.
    Launches count on :data:`launches`, per shard."""
    def sharded_pair(xs, k1, b1, k2, b2):
        def one(x, dev, rows, hw):
            return conv_pair(x, *M.replicas(dev, k1, b1, k2, b2), pool=pool, gram=gram,
                             gram_rows=rows, hw=hw)

        return M.map_shards(one, xs, HALO, pool=pool, gram=gram, home=mesh.home)

    return sharded_pair
