"""Fused single 3x3 conv (+ReLU), optional 2x2 average pool and optional
Gram, with a VJP to the input; and the forms built from it.

Counterpart of ``style_transfer_tpu/ops/pallas/conv_single.py``
(``make_conv_single``, ``single_plain``/``single_gram``/``single_pool``,
``gram_tail``, ``make_pair_of_singles``, ``make_wide_single``,
``make_wide_pair_of_singles``). Same contract: ``f(x, k, b) -> out`` or
``(out, gram)``, ``x`` (1, H, W, Cin) with H and W even when pooling,
``out`` the pooled (1, H/2, W/2, Cout) or full (1, H, W, Cout) activation,
``gram`` the (Cout, Cout) fp32 Gram of the pre-pool activation / (H*W),
over the local column window ``gram_cols`` when one is given; the backward
returns the input cotangent only (the VGG weights are frozen: their
gradients are ``None``).

On a CUDA tensor the single runs on the hand-written kernels of
``csrc/conv3x3.cu`` and ``csrc/gram.cu``:

- forward: one conv launch writes y (bf16: the output when not pooling, and
  the backward's residual) and, when pooling, the 2x2 pool; then the Gram of
  y over the column window. Saved: y and the taps, no int8 ReLU mask (the
  TPU kernel's contract: the gate comes from ``y > 0``);
- backward: ``S = (dG + dG^T) / (H*W)`` and ``y S`` (fp32, zero outside the
  window) when the Gram is used, then one transposed conv whose prologue
  stages ``bf16(y > 0 ? [unpool](dy) + y S : 0)`` — the order and the one
  rounding point of the TPU kernel (``conv_single.py:177-197``).

On a CPU tensor it runs :func:`conv_single_plain` under autograd. Any other
device raises.

The W-sliced wrappers keep the reference's stitching in torch glue —
:data:`WIDE_HALO` halo columns per side, each slice's Gram over its owned
window, the Gram rescaled by ``(ow + 2*halo) / w`` — so a forced ``slices``
count is held against the JAX package. With ``slices=None`` they run
unsliced: the TPU slices W only to fit its 16 MiB scoped VMEM
(``vmem.wide_slices``), while the Hopper kernels tile W in their grid and
have no such ceiling, so the port has no slice-count rule. The owned width
is ``ceil(w / slices)`` rounded up to even (the pool pairs columns), not to
the TPU's 16-column sublane tile; any owned width stitches to the same
result. Each slice's Gram window is its owned span clipped to the image:
the reference gives every slice but the last the full owned width, so where
``(slices - 1) * owned > w`` (a forced count at a small width; its own
slice-count rule never picks one) it counts zero-padded columns beyond the
image, whose activations are ``relu(bias)``, in the Gram.

The mesh takes ``gram_rows = (lo, hi)`` and ``hw`` as the conv pair does
(``conv_pair.py``): the Gram over rows ``[lo, hi)`` only, divided by the
global H*W, and the backward's ``y S`` zero outside them.
:func:`make_sharded_single` and :func:`make_sharded_gram_tail` are the
mesh forms (JAX ``conv_single.py:635``, ``:428``), and
``make_pair_of_singles(mesh=...)`` chains two sharded singles, as the
reference does. Each shard runs the single on its rows plus one halo row of
each neighbour (the reach of a 3x3 conv), two where the pool pairs rows.

Left out from the TPU kernel: its row tiling and W-chunking (``_tile_for``,
``_w_chunks``), the row padding, and the global row offset ``off`` with its
row masks (an edge shard here has no halo rows); the W-sliced forms have no
mesh form, as the port runs them unsliced.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.ops.kernels.conv_pair import _rows
from style_transfer_tpu_torch.parallel import mesh as M

#: Kernel launches made by the single-conv wrappers (the chain's singles).
launches = LaunchCount()
#: Kernel launches made by :func:`gram_tail` (conv5_1 beyond conv_gram's range).
gram_tail_launches = LaunchCount()

#: Halo columns each side of a W slice (``vmem.WIDE_HALO``).
WIDE_HALO = 8


def conv_single_plain(x, k, b, *, pool: bool, gram: bool, gram_cols=None, gram_rows=None,
                      hw=None):
    """The single in plain PyTorch ops (autograd gives the VJP)."""
    y = torch.relu(vgg.conv3x3(x, k, b))
    out = vgg.pool2x2(y, "average") if pool else y
    if not gram:
        return out
    f = y
    if gram_cols is not None:
        col = torch.arange(y.shape[2], device=y.device)
        f = y * ((col >= gram_cols[0]) & (col < gram_cols[1])).to(y.dtype)[:, None]
    return out, losses.gram_matrix(f, rows=gram_rows, hw=hw)


class SingleFunction(torch.autograd.Function):
    """The single on the CUDA kernels; ``count`` receives the launches."""

    @staticmethod
    def forward(ctx, x, k, b, pool: bool, gram: bool, gram_cols, count: LaunchCount,
                gram_rows=None, hw=None):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the conv-single kernel takes bf16 input, got {x.dtype}")
        _, h, w, _ = x.shape
        y, _, pooled = _launch.conv3x3_fwd(
            x[0].contiguous(), _launch.taps(k), _launch.taps(b),
            y=True, pool=pool, count=count,
        )
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y, k)
        ctx.pool, ctx.gram, ctx.count = pool, gram, count
        ctx.cols = None if gram_cols is None else (w, *gram_cols)
        ctx.rows, ctx.hw = _rows(gram_rows, w), float(h * w if hw is None else hw)
        out = (pooled if pool else y)[None]
        if gram:
            cout = y.shape[2]
            g = _launch.gram(y.view(h * w, cout), cols=ctx.cols, rows=ctx.rows,
                             count=count) / ctx.hw
            return out, g
        return out

    @staticmethod
    def backward(ctx, d_out, d_gram=None):
        y, k = ctx.saved_tensors
        h, w, cout = y.shape
        bf = torch.bfloat16
        add = None
        if ctx.gram and d_gram is not None:
            s = ((d_gram + d_gram.T) / ctx.hw).to(bf).contiguous()
            add = _launch.gram_fs(
                y.view(h * w, cout), s, cols=ctx.cols, rows=ctx.rows, count=ctx.count
            ).view(h, w, cout)
        dy = None if d_out is None else d_out[0].to(bf).contiguous()
        dx = _launch.conv3x3_bwd_data(
            dy, _launch.taps_transposed(k), hw=(h, w), unpool=ctx.pool,
            pre_add=add, pre_gate=y, count=ctx.count,
        )
        return dx[None], None, None, None, None, None, None, None, None


def _single(x, k, b, *, pool: bool, gram: bool, gram_cols=None, count: LaunchCount,
            gram_rows=None, hw=None):
    n, h, w, _ = x.shape
    if n != 1 or (pool and (h % 2 or w % 2)):
        raise ValueError(f"conv single expects (1, even H, even W, C), got {tuple(x.shape)}")
    if x.device.type == "cuda":
        return SingleFunction.apply(x, k, b, pool, gram, gram_cols, count, gram_rows, hw)
    if x.device.type == "cpu":
        return conv_single_plain(x, k, b, pool=pool, gram=gram, gram_cols=gram_cols,
                                 gram_rows=gram_rows, hw=hw)
    raise ValueError(f"conv_single runs on CUDA or CPU tensors, got device {x.device}")


def make_conv_single(*, pool: bool, gram: bool, gram_cols=None):
    """``f(x, k, b)``: the single with the given epilogues (module
    docstring); ``gram_cols = (lo, hi)`` restricts the Gram to local
    columns ``[lo, hi)``, still normalized by the local H*W."""

    def single(x, k, b):
        return _single(x, k, b, pool=pool, gram=gram, gram_cols=gram_cols, count=launches)

    return single


#: plain fused conv (chain interior)
single_plain = make_conv_single(pool=False, gram=False)
#: first conv of a block: its activation feeds on and its Gram is a style target
single_gram = make_conv_single(pool=False, gram=True)
#: last conv of a block: conv + ReLU + 2x2 average pool
single_pool = make_conv_single(pool=True, gram=False)


def gram_tail(x, k, b):
    """``conv_gram``'s contract — (1, H, W, Cin) -> (Cout, Cout) fp32 Gram of
    relu(conv(x) + b) / (H*W), input gradient only — delivered by the single
    with its activation discarded (its cotangent reads as zero); the
    dispatch takes it for conv5_1 beyond conv_gram's range
    (``dispatch.gram_tail_impl``). Launches count under
    :data:`gram_tail_launches`."""
    return _single(x, k, b, pool=False, gram=True, count=gram_tail_launches)[1]


def _chain(first, second, gram: bool):
    def pair(x, k1, b1, k2, b2):
        if gram:
            y1, g = first(x, k1, b1)
            return second(y1, k2, b2), g
        return second(first(x, k1, b1), k2, b2)

    return pair


def make_pair_of_singles(*, pool: bool, gram: bool, mesh=None):
    """A drop-in for ``conv_pair.conv_pair`` built from two singles: same
    signature ``f(x, k1, b1, k2, b2)`` and outputs (``(out, gram)`` when
    ``gram`` else ``out``, the Gram of the first activation). With a
    ``mesh``, the drop-in for ``conv_pair.make_sharded_pair``: two
    :func:`make_sharded_single` s on lists of H shards."""
    if mesh is not None:
        return _chain(make_sharded_single(mesh, pool=False, gram=gram),
                      make_sharded_single(mesh, pool=pool, gram=False), gram)
    return _chain(single_gram if gram else single_plain,
                  single_pool if pool else single_plain, gram)


def make_sharded_single(mesh, *, pool: bool, gram: bool):
    """:func:`make_conv_single` on a 1-D spatial mesh (JAX
    ``make_sharded_single``): ``f(xs, k, b)`` on a list of H shards returns
    the output shards (and the Gram, summed on the mesh's home device). Each
    shard runs the single on its rows plus one row of each neighbour, two
    when pooling; launches count on :data:`launches`, per shard."""
    def sharded_single(xs, k, b):
        def one(x, dev, rows, hw):
            return _single(x, *M.replicas(dev, k, b), pool=pool, gram=gram, count=launches,
                           gram_rows=rows, hw=hw)

        return M.map_shards(one, xs, 2 if pool else 1, pool=pool, gram=gram, home=mesh.home)

    return sharded_single


def make_sharded_gram_tail(mesh):
    """:func:`gram_tail` on a 1-D spatial mesh (JAX
    ``make_sharded_gram_tail``): ``f(xs, k, b) -> gram`` on the home device,
    each shard's single run on its rows plus one row of each neighbour;
    launches count on :data:`gram_tail_launches`, per shard."""
    def sharded_gram_tail(xs, k, b):
        def one(x, dev, rows, hw):
            return _single(x, *M.replicas(dev, k, b), pool=False, gram=True,
                           count=gram_tail_launches, gram_rows=rows, hw=hw)[1]

        return M.map_shards(one, xs, 1, pool=False, gram=True, out=False, home=mesh.home)

    return sharded_gram_tail


def _owned(w: int, n: int) -> int:
    a = -(-w // n)
    return a + a % 2


def make_wide_single(*, pool: bool, gram: bool, slices=None):
    """The single with W cut into ``slices`` slices of owned columns, each
    extended by :data:`WIDE_HALO` halo columns per side (zero beyond the
    image), stitched as the reference stitches them: halo output columns
    dropped, per-slice Grams over the owned window summed and rescaled from
    the slice's H*slice_w to the image's H*W. Reverse mode through the pad,
    slices and concatenation overlap-sums the per-slice input cotangents.
    ``slices`` None or 1: the unsliced single (module docstring)."""

    def wide(x, k, b):
        if slices is None or slices == 1:
            return _single(x, k, b, pool=pool, gram=gram, count=launches)
        n, hw, w = slices, WIDE_HALO, x.shape[2]
        ow = _owned(w, n)
        xe = F.pad(x, (0, 0, hw, n * ow - w + hw))
        lo, span = (hw // 2, ow // 2) if pool else (hw, ow)
        outs, g_sum = [], None
        for j in range(n):
            owned = min(ow, max(0, w - j * ow))  # the tail's surplus columns own nothing
            r = _single(xe[:, :, j * ow : j * ow + ow + 2 * hw], k, b, pool=pool, gram=gram,
                        gram_cols=(hw, hw + owned) if gram else None, count=launches)
            o, g = r if gram else (r, None)
            outs.append(o[:, :, lo : lo + span])
            if gram:
                g_sum = g if g_sum is None else g_sum + g
        out = torch.cat(outs, dim=2)[:, :, : (w // 2 if pool else w)]
        if not gram:
            return out
        return out, g_sum * ((ow + 2 * hw) / w)

    return wide


def make_wide_pair_of_singles(*, pool: bool, gram: bool, slices=None):
    """:func:`make_pair_of_singles` built from two W-sliced singles."""
    return _chain(make_wide_single(pool=False, gram=gram, slices=slices),
                  make_wide_single(pool=pool, gram=False, slices=slices), gram)
