"""Weights and images drawn from a run's seed, on the run's device.

Both sides of the comparison get these same tensors: the program through
``StyleTransfer(params, mean, std)`` and ``stylize(content, style)``, the
reference through its own :class:`~stbench.reference.objective.Objective`.
Each draw is a few large calls on a ``torch.Generator`` of the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from stbench.reference.objective import BLOCKS, CONV_NAMES

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# streams of one seed: weights, then images by their index (-1: the warm-up)
_WEIGHTS, _IMAGES = 0, 1


def _generator(device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7919 + index * 104_729) % (2 ** 63))
    return g


def vgg19_weights(seed: int, device, bias_std: float) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-normal kernels (HWIO, std sqrt(2 / (9 cin))) and normal biases of
    VGG-19's sixteen convolutions, float32, from one draw of each."""
    shapes = []
    cin = 3
    for n, c in BLOCKS:
        for _ in range(n):
            shapes.append((cin, c))
            cin = c
    g = _generator(device, seed, _WEIGHTS)
    kernels = torch.randn(sum(9 * a * b for a, b in shapes), generator=g, device=device)
    biases = torch.randn(sum(b for _, b in shapes), generator=g, device=device) * bias_std
    params, ko, bo = {}, 0, 0
    for name, (a, b) in zip(CONV_NAMES, shapes):
        k = kernels[ko:ko + 9 * a * b].view(3, 3, a, b) * (2.0 / (9 * a)) ** 0.5
        params[name] = {"kernel": k, "bias": biases[bo:bo + b]}
        ko, bo = ko + 9 * a * b, bo + b
    return params


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
