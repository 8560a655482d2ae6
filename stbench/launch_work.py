"""Operations and least bytes of the program's own kernel launches, from the
shapes its launch counter records (``style_transfer_tpu_torch.trace
.counts()``: ``{(wrapper, kernel, shape): launches}``, the shapes listed in
``ops/kernels/_launch.py``'s docstring), and a kernel's share of its
roofline over the traced slice.

A launch's least time is the larger of its operations at the bf16 peak and
its bytes at the memory's: what the card could not do faster for the same
work. The bytes are each operand the arithmetic needs, read once, and the
output, written once, in bf16; a stride-2 read counts the pixels it
samples, since those are all it needs (at ResNet-50's 256-1024 channels a
pixel is 512-2048 bytes, whole cache lines, so the others need not be
read).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

_PEAKS = Path(__file__).with_name("peaks.json")

#: The launchers of ``csrc/conv1x1.cu``'s GEMM, and the symbol its kernel
#: has in the device trace.
CONV1X1 = ("conv1x1_fwd", "conv1x1_bwd_data")
CONV1X1_SYMBOL = "conv1x1_kernel"


def _strided(n: int, stride: int) -> int:
    return -(-n // stride)


def conv1x1(kernel: str, shape: tuple) -> Tuple[float, float]:
    """``(FLOPs, least bytes)`` of one ``conv1x1_fwd`` or
    ``conv1x1_bwd_data`` launch: ``2 P K N`` over its P output pixels; the
    input at the pixels the product reads, the (K, N) weights, the output,
    the bias (forward), and the extra operands (the residual forward; the
    added cotangent, at half the extent where ``add_sub``, and the gate
    backward)."""
    if kernel == "conv1x1_fwd":
        h, w, k, n, stride, residual, _ = shape
        ho, wo = _strided(h, stride), _strided(w, stride)
        extra = (ho * wo * n if residual else 0) + n
    elif kernel == "conv1x1_bwd_data":
        h, w, k, n, add, add_sub, gate = shape
        ho, wo = h, w
        sub = _strided(h, 2) * _strided(w, 2) if add_sub else h * w
        extra = (sub * n if add else 0) + (h * w * n if gate else 0)
    else:
        raise ValueError(f"not a conv1x1 launcher: {kernel!r}")
    p = ho * wo
    return 2.0 * p * k * n, 2.0 * (p * k + k * n + p * n + extra)


def hbm_bytes_per_s(peak_flops: float) -> Optional[float]:
    """The memory's peak of the device whose bf16 peak is ``peak_flops``."""
    for entry in json.loads(_PEAKS.read_text()).values():
        if entry.get("bf16_flops_per_s") == peak_flops:
            return entry.get("hbm_bytes_per_s")
    return None


def least_seconds(counts: Dict[tuple, int], launchers, work, peak_flops: float,
                  peak_bytes: float) -> float:
    """The summed least time of every counted launch of ``launchers``."""
    total = 0.0
    for (_, kernel, shape), n in counts.items():
        if kernel in launchers:
            flops, nbytes = work(kernel, shape)
            total += n * max(flops / peak_flops, nbytes / peak_bytes)
    return total


def roofline_pct(counts: Dict[tuple, int], device_op_s: Dict[str, float], launchers, work,
                 symbol: str, peak_flops: Optional[float]) -> Optional[float]:
    """100 x the launches' least time over the device seconds of the
    operations whose name holds ``symbol``; None where either is zero or the
    device's peaks are unknown."""
    peak_bytes = hbm_bytes_per_s(peak_flops) if peak_flops else None
    if not peak_bytes:
        return None
    spent = sum(s for name, s in device_op_s.items() if symbol in name)
    least = least_seconds(counts, launchers, work, peak_flops, peak_bytes)
    if not spent or not least:
        return None
    return 100.0 * least / spent
