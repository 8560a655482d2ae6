"""Fused VGG block 1: conv1_1 + ReLU + conv1_2 + ReLU + 2x2 average pool,
plus the conv1_1 Gram, with a VJP to the block's input. Three entry points:

- :func:`block1_packed` — counterpart of ``style_transfer_tpu/ops/pallas/
  block1_packed.py::block1_packed``, the default chain's block 1. It is the
  conv pair with Cin=3, Cmid=64 and both epilogues, so on a CUDA tensor it
  runs the generic kernels (``csrc/conv3x3.cu``, ``csrc/gram.cu``) through
  :class:`~style_transfer_tpu_torch.ops.kernels.conv_pair.PairFunction`: two
  forward and two backward conv launches with r1 in device memory between
  them.
- :func:`block1_full` — counterpart of ``ops/pallas/block1.py::block1_full``,
  the opt-in ``fused_block1`` path. Same contract as ``block1_packed``, one
  pass from the image: ``csrc/block1.cu`` builds the 27-wide patches of a
  tile in shared memory, computes conv1_1 on the tensor cores into the r1
  tile there, writes r1 once as the residual, runs conv1_2 + ReLU + pool and
  the Gram from the tile on chip, and its backward ends in the 27-wide
  ``dpre1 @ k1f^T``; the col2im that gathers the patch cotangents onto the
  image is a small kernel of the same source (the reference keeps it in
  XLA), with :func:`_col2im3` as its plain version.
- :func:`block1_tail` — counterpart of ``ops/pallas/block1.py::block1_tail``:
  the same from a stored ``r1 = relu(conv1_1)``, ``(r1, k2, b2) -> (pool1,
  gram)``; its backward returns ``d_r1`` (transposed conv1_2 of the gated
  unpooled cotangent plus ``r1 S``), not gated by ``r1``.

Contract of the first two: ``(x, k1, b1, k2, b2) -> (pool1 (1, H/2, W/2, 64),
gram (64, 64) fp32 / (H*W))`` for the preprocessed image ``x`` (1, H, W, 3),
H and W even; the backward differentiates w.r.t. the image only. The VGG
weights are frozen: their gradients are ``None`` on both devices (on a CPU
tensor the plain versions get them detached, ``_weights.frozen``), the
PyTorch form of the reference's structural zeros
(``tests/test_weight_grads.py``); ``block1_tail`` likewise. ``block1_full`` and
``block1_tail`` make one forward and one backward kernel launch per call
(the Gram's fixed-order reduce pass and ``block1_full``'s col2im aside) and
take bf16 on the card; on a CPU tensor every entry point runs its plain
version under autograd.

The kernels are bf16 tensor-core kernels (``mma.sync`` from ``ldmatrix``):
one persistent block per SM walks a run of 16x16-pixel tiles with all nine
conv1_2 taps resident in shared memory, the next tile's loads in flight
behind the current tile's MMAs, and the Gram kept in registers across the
run; what bounds them (operations and bytes at once: about 0.18 ms each at
1024x1024) and what the design does about it stands in the source's header.
The weights reach them in three prepared forms, each made once per tensor
(``_weights``): bf16 taps, the flipped transposed taps, and conv1_1's taps
as (32, 64) with rows 27..31 zero; the biases as fp32. Sizes: any even H and
W; tiles ``H/16 * W/16 < 2^31`` and ``3 W < 2^31``.

:func:`make_sharded_block1` is ``block1_packed`` on a 1-D spatial mesh
(JAX ``block1_packed.py:730``): the conv pair's mesh form
(``conv_pair.make_sharded_pair``) with Cin=3, both epilogues, :data:`HALO`
rows and the block-1 counter. ``block1_full`` and ``block1_tail`` have no mesh form, as
in the reference, which runs the opt-in path on one device only.

Left out from the TPU kernels: the W-pair lane packing and the packed im2col
(``block1_packed.py``), the XLA-side ``_im2col3``, the row padding to 16
(``_pad_h``), ``_tile_h``, the W-duplicated cotangent and the ``vmem.py``
envelope. The kernels need even H and W and nothing else.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch, _weights
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.parallel import mesh as M

C = 64

#: Halo rows each way of a shard under :func:`make_sharded_block1`: the conv
#: pair's (two 3x3 convs). The TPU's 4 (``block1_packed.py:680``) also
#: covers its clamped edge blocks.
HALO = CP.HALO

#: Kernel launches made by :func:`block1_packed`.
launches = LaunchCount("block1_packed")
#: Kernel launches made by :func:`block1_full`.
full_launches = LaunchCount("block1_full")
#: Kernel launches made by :func:`block1_tail`.
tail_launches = LaunchCount("block1_tail")


def block1_plain(x, k1, b1, k2, b2, *, gram_rows=None, hw=None):
    """Block 1 in plain PyTorch ops (autograd gives the VJP): the plain
    version of :func:`block1_packed` and of :func:`block1_full`."""
    return CP.conv_pair_plain(x, k1, b1, k2, b2, pool=True, gram=True, gram_rows=gram_rows,
                              hw=hw)


def block1_tail_plain(r1, k2, b2):
    """conv1_2 + ReLU + pool and the Gram of ``r1`` in plain PyTorch ops."""
    y2 = torch.relu(vgg.conv3x3(r1, k2, b2))
    return vgg.pool2x2(y2, "average"), losses.gram_matrix(r1)


def block1_packed(x, k1, b1, k2, b2, *, gram_rows=None, hw=None):
    """Whole VGG block 1 on the generic conv-pair kernels; see the module
    docstring. ``gram_rows`` and ``hw`` are the conv pair's (a mesh
    shard's Gram window and the global divisor). Differentiates w.r.t.
    ``x`` only: the frozen weights' gradients are ``None``."""
    n, h, w, c = x.shape
    if n != 1 or c != 3 or h % 2 or w % 2:
        raise ValueError("block1_packed expects (1, even H, even W, 3)")
    if x.device.type == "cuda":
        return CP.PairFunction.apply(x, k1, b1, k2, b2, True, True, launches, gram_rows, hw)
    if x.device.type == "cpu":
        return block1_plain(x, *_weights.frozen(k1, b1, k2, b2), gram_rows=gram_rows, hw=hw)
    raise ValueError(f"block1_packed runs on CUDA or CPU tensors, got device {x.device}")


def make_sharded_block1(mesh):
    """:func:`block1_packed` on a 1-D spatial mesh (JAX
    ``make_sharded_block1``): ``f(xs, k1, b1, k2, b2) -> (pool1 shards,
    gram)`` for the preprocessed image as a list of H shards; each shard
    runs block 1 on its rows plus :data:`HALO` rows of each neighbour
    (launches count on :data:`launches`, per shard), the Gram is summed on
    the mesh's home device."""
    def sharded_block1(xs, k1, b1, k2, b2):
        def one(x, dev, rows, hw):
            return block1_packed(x, *M.replicas(dev, k1, b1, k2, b2), gram_rows=rows, hw=hw)

        return M.map_shards(one, xs, HALO, pool=True, gram=True, home=mesh.home)

    return sharded_block1


def _sym(d_gram, hw: int, like):
    """``S = (dG + dG^T) / (H*W)`` in the activation dtype (zeros without a
    Gram cotangent)."""
    if d_gram is None:
        return torch.zeros((C, C), dtype=torch.bfloat16, device=like.device)
    return ((d_gram + d_gram.T) / float(hw)).to(torch.bfloat16).contiguous()


def _pooled_cotangent(d_pool, r1):
    """The pooled cotangent as (H/2, W/2, 64) bf16 (zeros where autograd did
    not materialize one)."""
    if d_pool is None:
        h, w, _ = r1.shape
        return torch.zeros((h // 2, w // 2, C), dtype=torch.bfloat16, device=r1.device)
    return d_pool[0].to(torch.bfloat16).contiguous()


def _col2im3(dpt):
    """Tap-major (9, H, W, 3) patch cotangents -> (H, W, 3) fp32 image
    cotangent: each tap scatters back shifted (the reference's ``_col2im3``),
    summed in fp32 in tap order. The plain version of
    ``_launch.block1_col2im``."""
    _, h, w, _ = dpt.shape
    dx = torch.zeros((h + 2, w + 2, 3), dtype=torch.float32, device=dpt.device)
    for t in range(9):
        dy, tx = divmod(t, 3)
        dx[dy : dy + h, tx : tx + w] += dpt[t]
    return dx[1:-1, 1:-1]


class FullFunction(torch.autograd.Function):
    """``block1_full`` on ``csrc/block1.cu``."""

    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the block-1 kernel takes bf16 input, got {x.dtype}")
        _, h, w, _ = x.shape
        pool, gram, r1, mask = _launch.block1_fwd(
            x[0].contiguous(), _launch.taps(k2), _weights.fp32(b2),
            k1=_weights.conv1_taps(k1), b1=_weights.fp32(b1), count=full_launches,
        )
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r1, mask, k1, k2)
        return pool[None], gram / float(h * w)

    @staticmethod
    def backward(ctx, d_pool, d_gram):
        r1, mask, k1, k2 = ctx.saved_tensors
        h, w, _ = r1.shape
        dpt = _launch.block1_bwd(_pooled_cotangent(d_pool, r1), mask, r1,
                                 _sym(d_gram, h * w, r1), _launch.taps_transposed(k2),
                                 k1=_weights.conv1_taps(k1), count=full_launches)
        return _launch.block1_col2im(dpt)[None], None, None, None, None


class TailFunction(torch.autograd.Function):
    """``block1_tail`` on ``csrc/block1.cu``."""

    @staticmethod
    def forward(ctx, r1, k2, b2):
        if r1.dtype != torch.bfloat16:
            raise ValueError(f"the block-1 kernel takes bf16 input, got {r1.dtype}")
        _, h, w, _ = r1.shape
        r = r1[0].contiguous()
        pool, gram, _, mask = _launch.block1_fwd(
            r, _launch.taps(k2), _weights.fp32(b2), count=tail_launches,
        )
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, mask, k2)
        return pool[None], gram / float(h * w)

    @staticmethod
    def backward(ctx, d_pool, d_gram):
        r1, mask, k2 = ctx.saved_tensors
        h, w, _ = r1.shape
        d_r1 = _launch.block1_bwd(_pooled_cotangent(d_pool, r1), mask, r1,
                                  _sym(d_gram, h * w, r1), _launch.taps_transposed(k2),
                                  count=tail_launches)
        return d_r1[None], None, None


def block1_full(x, k1, b1, k2, b2):
    """Whole VGG block 1 in one pass from the preprocessed image; see the
    module docstring. Differentiates w.r.t. ``x`` only: the frozen
    weights' gradients are ``None``."""
    n, h, w, c = x.shape
    if n != 1 or c != 3 or h % 2 or w % 2:
        raise ValueError("block1_full expects (1, even H, even W, 3)")
    if x.device.type == "cuda":
        return FullFunction.apply(x, k1, b1, k2, b2)
    if x.device.type == "cpu":
        return block1_plain(x, *_weights.frozen(k1, b1, k2, b2))
    raise ValueError(f"block1_full runs on CUDA or CPU tensors, got device {x.device}")


def block1_tail(r1, k2, b2):
    """conv1_2 + ReLU + average pool and the conv1_1 Gram from the stored
    activation ``r1`` (1, H, W, 64), H and W even; see the module docstring.
    Differentiates w.r.t. ``r1`` only: the frozen weights' gradients are
    ``None``."""
    n, h, w, c = r1.shape
    if n != 1 or c != C or h % 2 or w % 2:
        raise ValueError("block1_tail expects (1, even H, even W, 64)")
    if r1.device.type == "cuda":
        return TailFunction.apply(r1, k2, b2)
    if r1.device.type == "cpu":
        return block1_tail_plain(r1, *_weights.frozen(k2, b2))
    raise ValueError(f"block1_tail runs on CUDA or CPU tensors, got device {r1.device}")
