"""The scale ladder, the between-scale resize and the uint8 output, written
out in plain PyTorch for the benchmark's reference.

A frozen copy of what ``stylize`` promises, not an import of it: the scale
sizes of a coarse-to-fine ladder (the long side grows by ``factor`` up to the
requested size, each side rounded to an even number of at least 8 pixels),
the Lanczos-3 resize of ``jax.image.resize`` (separable, antialiased on
downsample by widening the kernel by the scale factor, weights renormalized
per output sample, axes whose size does not change left alone, clipped to
[0, 1]) and the uint8 quantization (clip, times 255, plus 0.5, truncate).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


def scale_size(hw: Tuple[int, int], long_side: int) -> Tuple[int, int]:
    """(H, W) scaled so that the longer side is ``long_side``."""
    h, w = hw
    if h >= w:
        return long_side, max(1, round(w * long_side / h))
    return max(1, round(h * long_side / w)), long_side


def round_even(x: float) -> int:
    return max(8, int(round(x / 2.0)) * 2)


def ladder(content_hw: Tuple[int, int], size: int, iterations: Sequence[int], *,
           min_scale: int, factor: float = 2.0) -> List[Tuple[Tuple[int, int], int]]:
    """``[((H, W), iterations), ...]`` coarse to fine; the last count repeats."""
    end = scale_size(content_hw, size)
    longs = [max(end)]
    while longs[-1] / factor >= min_scale:
        longs.append(longs[-1] / factor)
    sizes: List[Tuple[int, int]] = []
    for s in reversed(longs):
        h, w = scale_size(end, int(round(s)))
        hw = (round_even(h), round_even(w))
        if not sizes or hw != sizes[-1]:
            sizes.append(hw)
    return [(hw, int(iterations[min(i, len(iterations) - 1)])) for i, hw in enumerate(sizes)]


def style_size(style_hw: Tuple[int, int], scale_hw: Tuple[int, int],
               style_scale: float = 1.0) -> Tuple[int, int]:
    """The style image's size at a scale: long side ``style_scale`` times the
    scale's (at least 32), each side rounded down to even."""
    long_side = max(32, int(round(max(scale_hw) * style_scale)))
    sh, sw = scale_size(style_hw, long_side)
    return sh - sh % 2, sw - sw % 2


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    r = 3.0
    y = r * torch.sin(math.pi * x) * torch.sin(math.pi * x / r)
    safe = torch.where(x != 0, math.pi ** 2 * x * x, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > r, torch.zeros_like(x), out)


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) resampling weights for a pure scale."""
    inv = n_in / n_out
    widen = max(inv, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _lanczos3((centre[None, :] - src[:, None]).abs() / widen)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(image: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Lanczos-3 resize of an NHWC float image to ``hw``, clipped to [0, 1]."""
    _, h_in, w_in, _ = image.shape
    out = image.to(torch.float32)
    if hw[0] != h_in:
        out = torch.einsum("nhwc,hk->nkwc", out, _weights(h_in, hw[0], image.device))
    if hw[1] != w_in:
        out = torch.einsum("nhwc,wk->nhkc", out, _weights(w_in, hw[1], image.device))
    return out.clamp(0.0, 1.0)


def from_u8(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, H, W, 3) float32 in [0, 1]."""
    return image[None].to(torch.float32) * (1.0 / 255.0)


def quantize(image: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 3) float -> (H, W, 3) uint8."""
    return (image[0].to(torch.float32).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
