"""Fused VGG block 2: conv2_1 + ReLU + conv2_2 + ReLU + 2x2 average pool,
plus the conv2_1 Gram.

Counterpart of ``style_transfer_tpu/ops/pallas/block2.py::block2_fused``:
the conv pair (:mod:`style_transfer_tpu_torch.ops.kernels.conv_pair`) with
both epilogues, behind the same input checks. Its launches count under the
conv pair's counter.
"""

from __future__ import annotations

from style_transfer_tpu_torch.ops.kernels import conv_pair as CP

CIN = 64
CMID = 128


def block2_fused(pool1, k1, b1, k2, b2):
    """``pool1`` (1, H2, W2, 64), H2 and W2 even -> ``(pool2 (1, H2/2, W2/2,
    128), gram (128, 128) fp32 / (H2*W2))``; differentiates w.r.t. ``pool1``."""
    n, h, w, c = pool1.shape
    if n != 1 or c != CIN or h % 2 or w % 2:
        raise ValueError("block2_fused expects (1, even H2, even W2, 64)")
    return CP.conv_pair(pool1, k1, b1, k2, b2, pool=True, gram=True)
