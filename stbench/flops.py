"""Closed-form work of one evaluation of the Gatys objective on a
configuration's architecture, and the chip's peaks.

The count is the model's, whatever implements it, from the architecture's
``work(hw, content_layers, style_layers)``: each convolution of the forward
to the deepest requested layer, ``2 h_out w_out kh kw cin cout``, counted
twice (the forward, and the backward of the frozen-weight network, input
gradients only: the same convolution work, transposed); each style layer's
Gram, ``2 h w c^2``, counted twice (its product and its backward product).
Pointwise work (ReLU, pooling, residual adds, TV, the optimizer) is left
out. An optimizer iteration counts one evaluation; an L-BFGS iteration's
extra line-search evaluations are not model work.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Tuple

_PEAKS = Path(__file__).with_name("peaks.json")


def work(arch, fields: dict, hw: Tuple[int, int]):
    """``(convs, grams)`` of one evaluation at an (H, W) image, for the
    layers the ``StylizeConfig`` ``fields`` name."""
    return arch.work(tuple(hw), tuple(fields["content_layers"]), tuple(fields["style_layers"]))


def flops_per_eval(arch, fields: dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one evaluation (value and gradient) at an (H, W) image."""
    convs, grams = work(arch, fields, hw)
    conv = sum(2.0 * ho * wo * kh * kw * cin * cout for ho, wo, kh, kw, cin, cout in convs)
    gram = sum(2.0 * h * w * c * c for h, w, c in grams)
    return 2.0 * conv + 2.0 * gram


def bytes_per_eval(arch, fields: dict, hw: Tuple[int, int], elem: int = 2) -> float:
    """The least bytes one evaluation moves at an (H, W) image: each
    convolution reads its input and writes its output forward, and reads
    the output's gradient and writes the input's backward, in ``elem``-byte
    elements (bf16), each counted at the output's extent (a strided
    convolution's input is counted short, so the bound stays a least one);
    weights and Grams are negligible at these sizes."""
    convs, _ = work(arch, fields, hw)
    act = sum(ho * wo * (cin + cout) for ho, wo, _, _, cin, cout in convs)
    return 2.0 * act * elem


def flops_per_ladder(arch, fields: dict, scales: Sequence[Tuple[Tuple[int, int], int]]) -> float:
    """Model FLOPs of one image: iterations times one evaluation, per scale."""
    return sum(n * flops_per_eval(arch, fields, hw) for hw, n in scales)


def peaks(kind: str) -> dict:
    """The published dense peaks of a device by its name, or ``{}``."""
    return json.loads(_PEAKS.read_text()).get(kind, {})
