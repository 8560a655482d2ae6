"""ResNet-50's forward on the hand-written kernels, with a VJP to the input.

Two wrappers carry the network (``models/resnet.py`` names its layers):

- :func:`stem_pool` ``(x, k, b) -> (pooled, act)``: the 7x7 stride-2 stem
  with its ReLU (``act``, the layer ``conv1``) and the 3x3 stride-2 max
  pool after it;
- :func:`stage` ``(x, params, s) -> out``: the bottlenecks of stage ``s``
  (``out`` is the layer ``layer<s>``).

Each differentiates with respect to its input only: the weights are frozen,
their gradients ``None`` on both devices (as the VGG wrappers'). On a CUDA
tensor they run on ``csrc/conv1x1.cu`` (every 1x1 and strided convolution,
as a GEMM on the warpgroup MMA with the bias, residual, ReLU and gate in its
epilogue), ``csrc/im2col.cu`` (the columns of the strided convolutions and
their adjoint, the max pool, the gate of a stage's cotangent) and
``csrc/conv3x3.cu`` (the stride-1 3x3s, on the tiles VGG-19 uses):

- stem forward: im2col of the image (7 x 7 x 3 = 147 columns, padded to
  :data:`~style_transfer_tpu_torch.models.resnet.STEM_COLUMNS`), the GEMM
  with ReLU, the max pool (its window indices kept); backward: the pool's
  adjoint with the layer's own cotangent added and the ReLU gate applied in
  one pass, the GEMM against the transposed kernel, col2im;
- a bottleneck forward: ``h1 = relu(x W1 + b1)``; ``h2``: the 3x3 (stride
  1: the conv3x3 tile with its ReLU; stride 2: im2col and the GEMM);
  the shortcut (``x``, or the projection, whose stride-2 read is the
  GEMM's own strided TMA load); ``out = relu(h2 W3 + b3 + shortcut)`` in
  one launch. Saved: the block's input, h1, h2 and out (bf16);
- a stage backward: ``g = out > 0 ? d_out : 0`` once (a stage's cotangent
  arrives summed from the next stage, its Gram and its content loss); then
  per bottleneck, last first: ``dh2 = h2 > 0 ? g W3^T : 0``; ``dh1`` from
  the 3x3's transposed taps gated by ``h1 > 0`` (stride 1), or the GEMM to
  the columns and col2im with that gate (stride 2); the input's two
  cotangents meet in one launch: ``dx = dh1 W1^T + g`` with the gate of the
  previous bottleneck's output, which is ``g`` for that bottleneck, or at
  a stage's head ``dx = dh1 W1^T + g Wd^T``, the projection's product
  landing on the even pixels where it has stride 2.

On a CPU tensor each runs its plain PyTorch version under autograd
(``models/resnet.py``'s functions, on detached weights). Beside them, the
plain form of each launcher's contract (``*_plain``), which the CPU tests
hold against ``F.conv2d`` / ``F.max_pool2d`` under autograd and the
``cuda`` tests hold the kernels against.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from style_transfer_tpu_torch.models import resnet as R
from style_transfer_tpu_torch.ops.kernels import _launch, _weights
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

#: Kernel launches made by the ResNet wrappers.
launches = LaunchCount("resnet")

_BF = torch.bfloat16


# ------------------------------------------------------------ plain forms


def conv1x1_plain(x, w, bias=None, *, stride: int = 1, add=None, add_sub: bool = False,
                  gate=None, relu: bool = False):
    """The contract of ``_launch.conv1x1_fwd`` / ``conv1x1_bwd_data`` in
    fp32: ``[gate >] [relu](x[::stride, ::stride] @ w [+ bias] [+ add])``,
    x (H, W, K), w (K, N), ``add`` at the output's extent or with
    ``add_sub`` at half of it on the even pixels."""
    x = x[::stride, ::stride].float()
    y = x @ w.float()
    if bias is not None:
        y = y + bias.float()
    if add is not None:
        if add_sub:
            full = torch.zeros_like(y)
            full[::2, ::2] = add.float()
            add = full
        y = y + add.float()
    if relu:
        y = torch.relu(y)
    if gate is not None:
        y = torch.where(gate > 0, y, torch.zeros_like(y))
    return y


def im2col_plain(x, kh: int, kw: int, stride: int, kp: int):
    """The contract of ``_launch.im2col`` in x's dtype: (Ho, Wo, kp)."""
    h, w, c = x.shape
    p = kh // 2
    ho, wo = _launch.strided_hw(h, w, stride)
    xp = F.pad(x, (0, 0, p, p, p, p))
    taps = [xp[ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(kh) for kx in range(kw)]
    col = torch.cat(taps, dim=2)
    return F.pad(col, (0, kp - col.shape[2]))


def col2im_plain(dcol, hw: Tuple[int, int], c: int, kh: int, kw: int, stride: int, gate=None):
    """The contract of ``_launch.col2im`` in fp32: the adjoint of
    :func:`im2col_plain`, zero where ``gate`` <= 0."""
    h, w = hw
    p = kh // 2
    ho, wo = _launch.strided_hw(h, w, stride)
    d = dcol.float()
    acc = torch.zeros((h + 2 * p, w + 2 * p, c), dtype=torch.float32, device=dcol.device)
    for ky in range(kh):
        for kx in range(kw):
            t = (ky * kw + kx) * c
            acc[ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride] += \
                d[:, :, t:t + c]
    dx = acc[p:p + h, p:p + w]
    if gate is not None:
        dx = torch.where(gate > 0, dx, torch.zeros_like(dx))
    return dx


def maxpool_plain(x):
    """The contract of ``_launch.maxpool_fwd``: the 3x3 stride-2 max pool
    (padding 1) of x (H, W, C) and the window index (0..8, int8) of each
    maximum, the first among equal values."""
    h, w, c = x.shape
    ho, wo = _launch.strided_hw(h, w, 2)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1), value=float("-inf"))
    best = idx = None
    for t in range(9):
        ky, kx = divmod(t, 3)
        v = xp[ky:ky + 2 * (ho - 1) + 1:2, kx:kx + 2 * (wo - 1) + 1:2]
        if best is None:
            best, idx = v, torch.zeros(v.shape, dtype=torch.int8, device=x.device)
        else:
            up = v > best
            best = torch.where(up, v, best)
            idx = torch.where(up, torch.full_like(idx, t), idx)
    return best.to(x.dtype), idx


def maxpool_bwd_plain(dy, idx, hw: Tuple[int, int], add=None, gate=None):
    """The contract of ``_launch.maxpool_bwd`` in fp32."""
    h, w = hw
    ho, wo, c = idx.shape
    acc = torch.zeros((h + 2, w + 2, c), dtype=torch.float32, device=idx.device)
    if dy is not None:
        for t in range(9):
            ky, kx = divmod(t, 3)
            acc[ky:ky + 2 * (ho - 1) + 1:2, kx:kx + 2 * (wo - 1) + 1:2] += \
                torch.where(idx == t, dy.float(), torch.zeros_like(dy, dtype=torch.float32))
    dx = acc[1:1 + h, 1:1 + w]
    if add is not None:
        dx = dx + add.float()
    if gate is not None:
        dx = torch.where(gate > 0, dx, torch.zeros_like(dx))
    return dx


def relu_gate_plain(dy, gate):
    """The contract of ``_launch.relu_gate``."""
    return torch.where(gate > 0, dy, torch.zeros_like(dy))


# --------------------------------------------------------------- kernels


class StemPoolFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, b):
        if x.dtype != _BF:
            raise ValueError(f"the ResNet kernels take bf16 input, got {x.dtype}")
        img = x[0].contiguous()
        col = _launch.im2col(img, 7, 7, 2, R.STEM_COLUMNS, count=launches)
        act = _launch.conv1x1_fwd(col, _weights.gemm(k), _weights.bf16(b), count=launches)
        pooled, idx = _launch.maxpool_fwd(act, count=launches)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(act, idx, k)
        ctx.hw = tuple(img.shape[:2])
        return pooled[None], act[None]

    @staticmethod
    def backward(ctx, d_pooled, d_act):
        act, idx, k = ctx.saved_tensors
        dp = None if d_pooled is None else d_pooled[0].to(_BF).contiguous()
        da = None if d_act is None else d_act[0].to(_BF).contiguous()
        if dp is None and da is None:
            return None, None, None
        if dp is None:
            dpre = _launch.relu_gate(da, act, count=launches)
        else:
            dpre = _launch.maxpool_bwd(dp, idx, tuple(act.shape[:2]), add=da, gate=act,
                                       count=launches)
        dcol = _launch.conv1x1_bwd_data(dpre, _weights.gemm_t(k), count=launches)
        dx = _launch.col2im(dcol, ctx.hw, 3, 7, 7, 2, count=launches)
        return dx[None], None, None


def _block_names(s: int) -> List[Tuple[str, bool]]:
    """``(prefix, projection)`` of stage ``s``'s bottlenecks."""
    return [(f"layer{s}.{b}.", b == 0) for b in range(R.STAGES[s - 1][0])]


def stage_weights(params, s: int) -> List[torch.Tensor]:
    """Stage ``s``'s kernels and biases in the order :class:`StageFunction`
    takes them: per bottleneck conv1, conv2, conv3 (and the projection)."""
    out = []
    for pre, proj in _block_names(s):
        for c in ("conv1", "conv2", "conv3") + (("downsample",) if proj else ()):
            out += [params[pre + c]["kernel"], params[pre + c]["bias"]]
    return out


class StageFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, *weights):
        if x.dtype != _BF:
            raise ValueError(f"the ResNet kernels take bf16 input, got {x.dtype}")
        stride = R.STAGES[s - 1][2]
        cur = x[0].contiguous()
        saved: List[torch.Tensor] = [cur]
        w = list(weights)
        for b, (_, proj) in enumerate(_block_names(s)):
            k1, b1, k2, b2, k3, b3 = w[:6]
            w = w[6:]
            st = stride if b == 0 else 1
            h1 = _launch.conv1x1_fwd(cur, _weights.gemm(k1), _weights.bf16(b1), count=launches)
            if st == 1:
                h2 = _launch.conv3x3_fwd(h1, _launch.taps(k2), _launch.taps(b2), y=True,
                                         count=launches)[0]
            else:
                col = _launch.im2col(h1, 3, 3, 2, 9 * h1.shape[2], count=launches)
                h2 = _launch.conv1x1_fwd(col, _weights.gemm(k2), _weights.bf16(b2), count=launches)
            if proj:
                kd, bd = w[:2]
                w = w[2:]
                sc = _launch.conv1x1_fwd(cur, _weights.gemm(kd), _weights.bf16(bd), stride=st, relu=False,
                                         count=launches)
            else:
                sc = cur
            cur = _launch.conv1x1_fwd(h2, _weights.gemm(k3), _weights.bf16(b3), residual=sc, count=launches)
            saved += [h1, h2, cur]
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*saved, *weights)
        ctx.s, ctx.n = s, len(saved)
        return cur[None]

    @staticmethod
    def backward(ctx, d_out):
        nones = (None,) * (len(ctx.saved_tensors) - ctx.n + 1)
        if d_out is None:
            return (None,) + nones
        t = ctx.saved_tensors
        acts, w = t[:ctx.n], list(t[ctx.n:])
        stride = R.STAGES[ctx.s - 1][2]
        g = _launch.relu_gate(d_out[0].to(_BF).contiguous(), acts[-1], count=launches)
        blocks = _block_names(ctx.s)
        offsets, o = [], 0
        for _, proj in blocks:
            offsets.append(o)
            o += 8 if proj else 6
        for b in reversed(range(len(blocks))):
            x_in, h1, h2 = acts[3 * b], acts[3 * b + 1], acts[3 * b + 2]
            k1, _, k2, _, k3 = w[offsets[b]:offsets[b] + 5]
            st = stride if b == 0 else 1
            dh2 = _launch.conv1x1_bwd_data(g, _weights.gemm_t(k3), gate=h2, count=launches)
            if st == 1:
                dh1 = _launch.conv3x3_bwd_data(dh2, _launch.taps_transposed(k2),
                                               hw=tuple(h1.shape[:2]), gate=h1, count=launches)
            else:
                dcol = _launch.conv1x1_bwd_data(dh2, _weights.gemm_t(k2), count=launches)
                dh1 = _launch.col2im(dcol, tuple(h1.shape[:2]), h1.shape[2], 3, 3, 2, gate=h1,
                                     count=launches)
            if b == 0:
                kd = w[offsets[b] + 6]
                dsc = _launch.conv1x1_bwd_data(g, _weights.gemm_t(kd), count=launches)
                g = _launch.conv1x1_bwd_data(dh1, _weights.gemm_t(k1), add=dsc, add_sub=st == 2,
                                             count=launches)
            else:
                g = _launch.conv1x1_bwd_data(dh1, _weights.gemm_t(k1), add=g, gate=x_in, count=launches)
        return (g[None],) + nones


def _plain_params(params, names) -> Dict[str, Dict[str, torch.Tensor]]:
    return {n: dict(zip(("kernel", "bias"), _weights.frozen(params[n]["kernel"],
                                                             params[n]["bias"])))
            for n in names}


def stem_pool(x, k, b):
    """``(pooled, act)`` of a preprocessed (1, H, W, 3) image: ``act`` the
    stem's ReLU output (1, ceil(H/2), ceil(W/2), 64), ``pooled`` its max
    pool (1, ceil(H/4), ceil(W/4), 64). The kernels on a CUDA tensor, the
    plain version on a CPU tensor; input gradient only."""
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"the stem expects (1, H, W, 3), got {tuple(x.shape)}")
    if x.device.type == "cuda":
        return StemPoolFunction.apply(x, k, b)
    if x.device.type == "cpu":
        p = _plain_params({"conv1": {"kernel": k, "bias": b}}, ["conv1"])
        act = R.stem(p, x)
        return R.max_pool(act), act
    raise ValueError(f"stem_pool runs on CUDA or CPU tensors, got device {x.device}")


def stage(x, params, s: int):
    """Stage ``s`` (1-4) of ResNet-50 on a (1, H, W, C) activation: the
    output of its last bottleneck. The kernels on a CUDA tensor, the plain
    version on a CPU tensor; input gradient only."""
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"a stage expects (1, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cuda":
        return StageFunction.apply(x, s, *stage_weights(params, s))
    if x.device.type == "cpu":
        names = [pre + c for pre, proj in _block_names(s)
                 for c in ("conv1", "conv2", "conv3") + (("downsample",) if proj else ())]
        return R.stage_forward(_plain_params(params, names), x, s)
    raise ValueError(f"stage runs on CUDA or CPU tensors, got device {x.device}")

