"""ResNet-50 in plain float32 PyTorch: its weights' draw, its forward and its
model work.

ResNet-50 is the 50-layer column of He et al., arXiv:1512.03385, Table 1,
in torchvision's "v1.5" layout (a downsampling bottleneck's stride on its
3x3): a 7x7 convolution of stride 2 and padding 3 to 64 channels and its
ReLU (the layer ``conv1``), a 3x3 max pool of stride 2 and padding 1, then
four stages of 3, 4, 6 and 3 bottlenecks of widths 64, 128, 256 and 512,
the first of stages 2-4 of stride 2. A bottleneck is a 1x1 to the width, a
3x3 (padding 1), a 1x1 to 4x the width, a ReLU after the first two, and
the ReLU of the last one's output plus the shortcut: the block's input, or
at a stage's first block a 1x1 projection of the stage's stride. The layer
``layer<s>`` is stage s's last block's output.

Departures from the published network, both those of a network at
inference with weights drawn from a seed: batch norm is folded into each
convolution (a bias per output channel, no normalization), and the weights
are drawn here (He-normal kernels, std sqrt(2 / (kh kw cin)); each
bottleneck's last convolution scaled by the file's ``branch_scale``, the
role of its batch norm's scale, which keeps the residual stream from
doubling its variance each block; normal biases of std ``bias_std``). No
classifier: the objective reads the layers above.

The configuration file states the shapes (``blocks``, ``widths``,
``expansion``) and the program's pooling (``program``); a file that states
others is refused here rather than judged against another network.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stbench.inputs import weights_generator

DEPTHS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
STEM = 64
LAYERS = ("conv1", "layer1", "layer2", "layer3", "layer4")


def _convs() -> Dict[str, Tuple[int, int, int, int, int]]:
    """``{name: (kh, kw, cin, cout, stride)}`` in forward order, under the
    program's key names."""
    out = {"conv1": (7, 7, 3, STEM, 2)}
    cin = STEM
    for s, (n, width) in enumerate(zip(DEPTHS, WIDTHS), start=1):
        for b in range(n):
            st = 2 if b == 0 and s > 1 else 1
            out[f"layer{s}.{b}.conv1"] = (1, 1, cin, width, 1)
            out[f"layer{s}.{b}.conv2"] = (3, 3, width, width, st)
            out[f"layer{s}.{b}.conv3"] = (1, 1, width, width * EXPANSION, 1)
            if b == 0:
                out[f"layer{s}.0.downsample"] = (1, 1, cin, width * EXPANSION, st)
            cin = width * EXPANSION
    return out


CONVS = _convs()


def _check(config: dict) -> None:
    stated = {"blocks": config.get("blocks"), "widths": config.get("widths"),
              "expansion": config.get("expansion"),
              "pooling": config.get("program", {}).get("pooling")}
    this = {"blocks": list(DEPTHS), "widths": list(WIDTHS), "expansion": EXPANSION,
            "pooling": "max"}
    if stated != this:
        raise ValueError(f"configuration {config.get('name')!r} states {stated}; "
                         f"stbench/arch/resnet50.py is {this}")


def weights(seed: int, device, config: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """The 53 convolutions' kernels (HWIO) and biases, float32, from one
    draw of each: ``{name: {"kernel", "bias"}}`` under torchvision's module
    names (``conv1``, ``layer<s>.<b>.conv1`` .. ``conv3``,
    ``layer<s>.0.downsample``), the layout the program takes ResNet-50's
    weights in."""
    _check(config)
    bias_std = float(config["bias_std"])
    branch = float(config["branch_scale"])
    g = weights_generator(seed, device)
    sizes = [kh * kw * ci * co for kh, kw, ci, co, _ in CONVS.values()]
    kernels = torch.randn(sum(sizes), generator=g, device=device)
    biases = torch.randn(sum(co for _, _, _, co, _ in CONVS.values()), generator=g,
                         device=device) * bias_std
    params, ko, bo = {}, 0, 0
    for (name, (kh, kw, ci, co, _)), n in zip(CONVS.items(), sizes):
        scale = (2.0 / (kh * kw * ci)) ** 0.5 * (branch if name.endswith("conv3") else 1.0)
        params[name] = {"kernel": kernels[ko:ko + n].view(kh, kw, ci, co) * scale,
                        "bias": biases[bo:bo + co]}
        ko, bo = ko + n, bo + co
    return params


def prepare(params, quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """``{name: (OIHW kernel, bias, stride)}`` in float32, kernel and bias
    rounded through ``quant`` where given."""
    q = quant or (lambda t: t)
    return {n: (q(params[n]["kernel"].detach().to(torch.float32).permute(3, 2, 0, 1).contiguous()),
                q(params[n]["bias"].detach().to(torch.float32)), CONVS[n][4])
            for n in CONVS}


def _conv(prepared, name: str, x: torch.Tensor, q) -> torch.Tensor:
    k, b, stride = prepared[name]
    return q(F.conv2d(q(x), k, b, stride=stride, padding=k.shape[-1] // 2))


def features(prepared, x: torch.Tensor, layers: Sequence[str],
             q: Callable[[torch.Tensor], torch.Tensor]) -> Dict[str, torch.Tensor]:
    """NCHW activations of ``layers`` for a normalized NCHW image, the
    forward run to the deepest of them; ``q`` rounds each convolution's
    input and output."""
    wanted = set(layers)
    deepest = max(LAYERS.index(l) for l in wanted)
    out: Dict[str, torch.Tensor] = {}
    x = torch.relu(_conv(prepared, "conv1", x, q))
    out["conv1"] = x
    if deepest > 0:
        x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s in range(1, deepest + 1):
        for b in range(DEPTHS[s - 1]):
            pre = f"layer{s}.{b}."
            y = torch.relu(_conv(prepared, pre + "conv1", x, q))
            y = torch.relu(_conv(prepared, pre + "conv2", y, q))
            y = _conv(prepared, pre + "conv3", y, q)
            sc = _conv(prepared, pre + "downsample", x, q) if b == 0 else x
            x = torch.relu(y + sc)
        out[f"layer{s}"] = x
    return {l: out[l] for l in wanted}


def _half(n: int) -> int:
    return (n - 1) // 2 + 1


def work(hw: Tuple[int, int], content_layers: Sequence[str], style_layers: Sequence[str]):
    """``(convs, grams)``: each convolution of the forward to the deepest
    requested layer as ``(h_out, w_out, kh, kw, cin, cout)`` at its output's
    extent (a stride-2 one halves its input's, rounding up), and each style
    layer's Gram as ``(h, w, c)``."""
    deepest = max(LAYERS.index(l) for l in set(content_layers) | set(style_layers))
    h, w = _half(hw[0]), _half(hw[1])
    convs: List[tuple] = [(h, w, 7, 7, 3, STEM)]
    shape = {"conv1": (h, w, STEM)}
    h, w = _half(h), _half(w)
    cin = STEM
    for s in range(1, deepest + 1):
        for b in range(DEPTHS[s - 1]):
            width = WIDTHS[s - 1]
            h2, w2 = (_half(h), _half(w)) if b == 0 and s > 1 else (h, w)
            convs += [(h, w, 1, 1, cin, width), (h2, w2, 3, 3, width, width),
                      (h2, w2, 1, 1, width, width * EXPANSION)]
            if b == 0:
                convs.append((h2, w2, 1, 1, cin, width * EXPANSION))
            h, w, cin = h2, w2, width * EXPANSION
        shape[f"layer{s}"] = (h, w, cin)
    return convs, [shape[l] for l in style_layers]
