"""Fused 3x3 conv + ReLU + channel Gram, with a VJP to the input.

Counterpart of ``style_transfer_tpu/ops/pallas/conv_gram.py::conv_gram``:
``(x (1, H, W, Cin), k, b) -> (Cout, Cout) fp32 Gram of relu(conv3x3(x) + b)
/ (H*W)``. VGG-19's conv5_1 is consumed only as its Gram, so nothing else
of the activation leaves the contract.

On a CUDA tensor: forward = conv (``csrc/conv3x3.cu``) writing y (bf16, the
saved residual, as on the TPU) and the Gram of y (``csrc/gram.cu``);
backward = ``S = (dG + dG^T) / (H*W)``, ``dpre = bf16(y > 0 ? y S : 0)``
(``gram.cu``'s gated F S) and the transposed conv to dx. The TPU kernel
fuses the y S product and the gate into its backward prologue; here they
are one extra launch. On a CPU tensor it runs :func:`conv_gram_plain`.

Left out from the TPU kernel: its row tiling, the ``vmem.gram_tail_impl``
envelope (and the W-chunked ``gram_tail`` alternative), and the mesh form
``make_sharded_conv_gram``.
"""

from __future__ import annotations

import torch

from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.ops import losses
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount

#: Kernel launches made by the conv+Gram wrapper.
launches = LaunchCount()


def conv_gram_plain(x, k, b):
    """conv + ReLU + Gram in plain PyTorch ops (autograd gives the VJP)."""
    return losses.gram_matrix(torch.relu(vgg.conv3x3(x, k, b)))


class ConvGramFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, b):
        n, h, w, _ = x.shape
        if n != 1:
            raise ValueError(f"conv_gram expects (1, H, W, C), got {tuple(x.shape)}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the conv_gram kernel takes bf16 input, got {x.dtype}")
        y, _, _ = _launch.conv3x3_fwd(
            x[0].contiguous(), _launch.taps(k), _launch.taps(b),
            y=True, count=launches,
        )
        ctx.save_for_backward(y, k)
        cout = y.shape[2]
        return _launch.gram(y.view(h * w, cout), count=launches) / float(h * w)

    @staticmethod
    def backward(ctx, d_gram):
        y, k = ctx.saved_tensors
        h, w, cout = y.shape
        s = ((d_gram + d_gram.T) / float(h * w)).to(torch.bfloat16).contiguous()
        dpre = _launch.gram_fs(y.view(h * w, cout), s, relu_gate=True, count=launches)
        dx = _launch.conv3x3_bwd_data(
            dpre.view(h, w, cout), _launch.taps_transposed(k), hw=(h, w), count=launches
        )
        return dx[None], None, None


def conv_gram(x, k, b):
    """The fused conv+Gram: CUDA kernels for a CUDA tensor,
    :func:`conv_gram_plain` for a CPU tensor."""
    if x.device.type == "cuda":
        return ConvGramFunction.apply(x, k, b)
    if x.device.type == "cpu":
        return conv_gram_plain(x, k, b)
    raise ValueError(f"conv_gram runs on CUDA or CPU tensors, got device {x.device}")
