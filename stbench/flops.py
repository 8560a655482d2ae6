"""Closed-form work of one objective evaluation of the Gatys objective on
VGG-19 (content ``conv4_2``, style ``conv1_1`` .. ``conv5_1``), and the
chip's peaks.

The count is the model's, whatever implements it: the forward to conv5_1,
the backward of the frozen-weight network (input gradients only: the same
convolution work, transposed), and each style layer's Gram with its
backward product. Pointwise work (ReLU, pooling, TV, the optimizer) is
left out. An optimizer iteration counts one evaluation; an L-BFGS
iteration's extra line-search evaluations are not model work.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Tuple

from stbench.reference.objective import BLOCKS

_PEAKS = Path(__file__).with_name("peaks.json")


def _convs_to_conv5_1():
    """(block index, cin, cout) of each convolution up to conv5_1."""
    out, cin = [], 3
    for b, (n, c) in enumerate(BLOCKS):
        for _ in range(n if b < 4 else 1):
            out.append((b, cin, c))
            cin = c
    return out


def flops_per_eval(hw: Tuple[int, int]) -> float:
    """Model FLOPs of one evaluation (value and gradient) at an (H, W) image."""
    h, w = hw
    conv = sum(2.0 * (h >> b) * (w >> b) * 9 * cin * cout for b, cin, cout in _convs_to_conv5_1())
    gram = sum(2.0 * (h >> b) * (w >> b) * c * c for b, (_, c) in enumerate(BLOCKS))
    return 2.0 * conv + 2.0 * gram


def bytes_per_eval(hw: Tuple[int, int], elem: int = 2) -> float:
    """The least bytes one evaluation moves at an (H, W) image: each
    convolution reads its input and writes its output forward, and reads
    the output's gradient and writes the input's backward, in ``elem``-byte
    elements (bf16); weights and Grams are negligible at these sizes."""
    h, w = hw
    act = sum((h >> b) * (w >> b) * (cin + cout) for b, cin, cout in _convs_to_conv5_1())
    return 2.0 * act * elem


def flops_per_ladder(scales: Sequence[Tuple[Tuple[int, int], int]]) -> float:
    """Model FLOPs of one image: iterations times one evaluation, per scale."""
    return sum(n * flops_per_eval(hw) for hw, n in scales)


def peaks(kind: str) -> dict:
    """The published dense peaks of a device by its name, or ``{}``."""
    return json.loads(_PEAKS.read_text()).get(kind, {})
