"""Weights' generators and images drawn from a run's seed, on the run's device.

Both sides of the comparison get the same tensors: the program through
``StyleTransfer(params, mean, std)`` and ``stylize(content, style)``, the
reference through its own :class:`~stbench.reference.objective.Objective`.
The weights are the configuration's architecture's draw
(``stbench/arch/<arch>.py``, ``weights``) on :func:`weights_generator`.
Each draw is a few large calls on a ``torch.Generator`` of the device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# streams of one seed: weights, then images by their index (-1: the warm-up)
_WEIGHTS, _IMAGES = 0, 1


def _generator(device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7919 + index * 104_729) % (2 ** 63))
    return g


def weights_generator(seed: int, device) -> torch.Generator:
    """The generator of a seed's weights, on ``device``: an architecture
    draws all its weights from it, in few large calls."""
    return _generator(device, seed, _WEIGHTS)


def image(seed: int, index: int, hw: Tuple[int, int], device, stream: int = 0) -> torch.Tensor:
    """An (H, W, 3) uint8 image with structure at every scale: octaves of
    uniform noise drawn at 1/128, 1/32, 1/8 and 1/1 of the size, upsampled
    bicubically, weighted 8:4:2:1."""
    h, w = hw
    g = _generator(device, seed, _IMAGES, 2 * index + stream)
    acc = torch.zeros((1, 3, h, w), device=device)
    total = 0.0
    for div, weight in ((128, 8.0), (32, 4.0), (8, 2.0), (1, 1.0)):
        small = torch.rand((1, 3, max(2, h // div), max(2, w // div)), generator=g, device=device)
        if div > 1:
            small = F.interpolate(small, size=(h, w), mode="bicubic", align_corners=False)
        acc += weight * small
        total += weight
    out = (acc[0] / total).clamp(0.0, 1.0).permute(1, 2, 0)
    lo, hi = out.amin(), out.amax()
    return ((out - lo) / (hi - lo) * 255.0 + 0.5).to(torch.uint8)


def images(seed: int, index: int, content_hw, style_hw, device):
    """The content and style images of one ``stylize`` call."""
    return image(seed, index, tuple(content_hw), device, 0), image(seed, index,
                                                                   tuple(style_hw), device, 1)
