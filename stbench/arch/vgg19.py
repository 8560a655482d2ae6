"""VGG-19 in plain float32 PyTorch: its weights' draw, its forward and its
model work.

VGG-19 is configuration E of Simonyan & Zisserman (arXiv:1409.1556): 3x3
convolutions with padding 1, each followed by a ReLU, in blocks of 2, 2, 4,
4 and 4 convolutions of 64, 128, 256, 512 and 512 channels, each block
ended by a 2x2 pooling of stride 2 (average pooling here, as Gatys et al.,
arXiv:1508.06576, suggest). Layers are named ``conv<block>_<index>``; a
layer's activation is its convolution's output after the ReLU.

The configuration file states these shapes (``convs_per_block``,
``widths``, ``kernel_size``) and the program's pooling (``program``); a
file that states others is refused here rather than judged against another
network.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stbench.inputs import weights_generator

BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))
CONV_NAMES = tuple(f"conv{b + 1}_{i + 1}" for b, (n, _) in enumerate(BLOCKS) for i in range(n))


def _check(config: dict) -> None:
    stated = {"convs_per_block": config.get("convs_per_block"), "widths": config.get("widths"),
              "kernel_size": config.get("kernel_size"),
              "pooling": config.get("program", {}).get("pooling", "average")}
    this = {"convs_per_block": [n for n, _ in BLOCKS], "widths": [c for _, c in BLOCKS],
            "kernel_size": 3, "pooling": "average"}
    if stated != this:
        raise ValueError(f"configuration {config.get('name')!r} states {stated}; "
                         f"stbench/arch/vgg19.py is {this}")


def weights(seed: int, device, config: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-normal kernels (HWIO, std sqrt(2 / (9 cin))) and normal biases
    (std ``config["bias_std"]``) of the sixteen convolutions, float32, from
    one draw of each: ``{conv name: {"kernel", "bias"}}``, the layout the
    program takes its VGG weights in."""
    _check(config)
    bias_std = float(config["bias_std"])
    shapes = []
    cin = 3
    for n, c in BLOCKS:
        for _ in range(n):
            shapes.append((cin, c))
            cin = c
    g = weights_generator(seed, device)
    kernels = torch.randn(sum(9 * a * b for a, b in shapes), generator=g, device=device)
    biases = torch.randn(sum(b for _, b in shapes), generator=g, device=device) * bias_std
    params, ko, bo = {}, 0, 0
    for name, (a, b) in zip(CONV_NAMES, shapes):
        k = kernels[ko:ko + 9 * a * b].view(3, 3, a, b) * (2.0 / (9 * a)) ** 0.5
        params[name] = {"kernel": k, "bias": biases[bo:bo + b]}
        ko, bo = ko + 9 * a * b, bo + b
    return params


def prepare(params, quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """``{conv name: (OIHW kernel, bias)}`` in float32, each rounded
    through ``quant`` where given."""
    w = {n: (params[n]["kernel"].detach().to(torch.float32).permute(3, 2, 0, 1).contiguous(),
             params[n]["bias"].detach().to(torch.float32))
         for n in CONV_NAMES}
    if quant is not None:
        w = {n: (quant(k), quant(b)) for n, (k, b) in w.items()}
    return w


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of an NCHW tensor; an odd edge repeats its last
    row or column first."""
    if x.shape[2] % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    if x.shape[3] % 2:
        x = torch.cat([x, x[:, :, :, -1:]], dim=3)
    return F.avg_pool2d(x, 2)


def features(prepared, x: torch.Tensor, layers: Sequence[str],
             q: Callable[[torch.Tensor], torch.Tensor]) -> Dict[str, torch.Tensor]:
    """NCHW activations of ``layers`` for a normalized NCHW image, the
    forward run to the deepest of them; ``q`` rounds each convolution's
    input and output."""
    wanted = set(layers)
    deepest = max(CONV_NAMES.index(l) for l in wanted)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    for b, (n, _) in enumerate(BLOCKS):
        for _ in range(n):
            name = CONV_NAMES[i]
            k, bias = prepared[name]
            x = q(torch.relu(F.conv2d(q(x), k, bias, padding=1)))
            if name in wanted:
                out[name] = x
            if i == deepest:
                return out
            i += 1
        x = _pool(x)
    return out


def work(hw: Tuple[int, int], content_layers: Sequence[str], style_layers: Sequence[str]):
    """``(convs, grams)``: each convolution of the forward to the deepest
    requested layer as ``(h_out, w_out, 3, 3, cin, cout)``, and each style
    layer's Gram as ``(h, w, c)``; a block's extent is its input's halved
    and rounded up, as :func:`_pool` makes it."""
    wanted = set(content_layers) | set(style_layers)
    deepest = max(CONV_NAMES.index(l) for l in wanted)
    h, w = hw
    convs: List[tuple] = []
    shape: Dict[str, tuple] = {}
    cin, i = 3, 0
    for n, c in BLOCKS:
        for _ in range(n):
            if i > deepest:
                break
            convs.append((h, w, 3, 3, cin, c))
            shape[CONV_NAMES[i]] = (h, w, c)
            cin, i = c, i + 1
        h, w = -(-h // 2), -(-w // 2)
    return convs, [shape[l] for l in style_layers]
