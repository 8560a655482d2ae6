"""ResNet-50 feature extractor on NHWC tensors: the plain path.

ResNet-50 is the 50-layer column of He et al., arXiv:1512.03385, Table 1,
in torchvision's "v1.5" layout (the stride of a downsampling bottleneck on
its 3x3, not its first 1x1): a 7x7 stride-2 stem of 64 channels with its
ReLU, a 3x3 stride-2 max pool, and four stages of 3, 4, 6 and 3
bottlenecks of widths 64, 128, 256 and 512. A bottleneck is 1x1 -> 3x3 ->
1x1 (the last widening to 4x the width), a ReLU after the first two, and
the sum of the last with the shortcut put through a ReLU. The shortcut is
the block's input, or at the first block of a stage a 1x1 projection (of
stride 2 from stage 2 on). Batch norm is folded into each convolution at
inference (:func:`fold_batch_norm`), so every convolution here carries a
bias and nothing else.

Params keep the VGG layout, ``{layer: {"kernel" (HWIO), "bias"}}``, with
torchvision's module names as keys: ``conv1``, ``layer<s>.<b>.conv1`` ..
``conv3`` and ``layer<s>.0.downsample``. Layers that a loss can read
(:data:`LAYER_NAMES`): ``conv1``, the stem's ReLU output before the max
pool, and ``layer1`` .. ``layer4``, each stage's last bottleneck output.

:func:`extract_features` is plain PyTorch (``F.conv2d`` on a channels-last
view), the port's ``use_fused=False`` route; the kernel route is
``ops/kernels/resnet.py``. The JAX package has no ResNet: this module has
no counterpart there.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

ARCH = "resnet50"
#: (bottlenecks, width, stride of the first) of each stage.
STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
EXPANSION = 4
STEM_CHANNELS = 64
LAYER_NAMES = ("conv1", "layer1", "layer2", "layer3", "layer4")
#: The pooling of ResNet-50's stem, the only one it takes.
POOLING = "max"
BN_EPS = 1e-5

Params = Dict[str, Dict[str, torch.Tensor]]


def _conv_shapes() -> Dict[str, tuple]:
    """``{name: (kh, kw, cin, cout, stride)}`` of every convolution, in
    forward order (a stage's projection right after its first block's
    convolutions)."""
    out = {"conv1": (7, 7, 3, STEM_CHANNELS, 2)}
    cin = STEM_CHANNELS
    for s, (n, width, stride) in enumerate(STAGES, start=1):
        for b in range(n):
            st = stride if b == 0 else 1
            out[f"layer{s}.{b}.conv1"] = (1, 1, cin, width, 1)
            out[f"layer{s}.{b}.conv2"] = (3, 3, width, width, st)
            out[f"layer{s}.{b}.conv3"] = (1, 1, width, width * EXPANSION, 1)
            if b == 0:
                out[f"layer{s}.0.downsample"] = (1, 1, cin, width * EXPANSION, st)
            cin = width * EXPANSION
    return out


CONV_SHAPES: Dict[str, tuple] = _conv_shapes()
CONV_NAMES: tuple = tuple(CONV_SHAPES)


def matches(params: Mapping[str, object]) -> bool:
    """Whether ``params`` has ResNet-50's key set."""
    return set(params.keys()) == set(CONV_NAMES)


def deepest_layer(layers: Sequence[str]) -> str:
    """The forward-order-latest of ``layers``; a ``ValueError`` naming
    ResNet-50's layers for any other name."""
    bad = [l for l in layers if l not in LAYER_NAMES]
    if bad:
        raise ValueError(f"unknown {ARCH} layer(s) {bad}; valid: {LAYER_NAMES}")
    return max(layers, key=LAYER_NAMES.index)


def init_params(seed: int = 0) -> Params:
    """He-normal kernels (std ``sqrt(2 / (kh kw cin))``), each bottleneck's
    last scaled by 0.5 (the role of its batch norm's scale: the residual
    stream's variance does not double each block), and normal biases of
    std 0.05, from ``numpy.random.RandomState(seed)``, float32 on the CPU."""
    rng = np.random.RandomState(seed)
    params: Params = {}
    for name, (kh, kw, cin, cout, _) in CONV_SHAPES.items():
        std = np.sqrt(2.0 / (kh * kw * cin)) * (0.5 if name.endswith("conv3") else 1.0)
        kernel = (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)
        bias = (rng.standard_normal(cout) * 0.05).astype(np.float32)
        params[name] = {"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(bias)}
    return params


def fold_batch_norm(state_dict: Mapping[str, torch.Tensor], eps: float = BN_EPS) -> Params:
    """A torchvision ResNet-50 state dict (``conv1.weight``, ``bn1.*``,
    ``layer1.0.conv1.weight``, ``layer1.0.bn1.*``, ``layer1.0.downsample.0
    .weight``, ``layer1.0.downsample.1.*``, ...; ``fc.*`` is ignored) as
    this module's params: each convolution's OIHW weight times its batch
    norm's ``weight / sqrt(running_var + eps)`` per output channel, as an
    HWIO kernel, and the bias ``bias - running_mean * that scale``, float32.
    The forward then equals the network's in eval mode."""
    def bn_of(conv: str) -> str:
        if conv == "conv1":
            return "bn1"
        if conv.endswith("downsample"):
            return conv + ".1"
        return conv[:-len("convN")] + "bn" + conv[-1]

    params: Params = {}
    for name in CONV_NAMES:
        wkey = name + (".0.weight" if name.endswith("downsample") else ".weight")
        w = torch.as_tensor(state_dict[wkey], dtype=torch.float32)
        bn = bn_of(name)
        gamma, beta, mean, var = (torch.as_tensor(state_dict[f"{bn}.{k}"], dtype=torch.float32)
                                  for k in ("weight", "bias", "running_mean", "running_var"))
        scale = gamma / torch.sqrt(var + eps)
        params[name] = {"kernel": (w * scale[:, None, None, None]).permute(2, 3, 1, 0).contiguous(),
                        "bias": beta - mean * scale}
    return params


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """A convolution of an NHWC input with an HWIO kernel, padding half the
    kernel (3 for the 7x7, 1 for a 3x3, none for a 1x1), in the input's
    dtype, the bias added after it."""
    k = kernel.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=k // 2)
    return y.permute(0, 2, 3, 1) + bias.to(x.dtype)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 stride-2 max pool with padding 1 of an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def _c(params, name, x, relu=True):
    p = params[name]
    y = conv(x, p["kernel"], p["bias"], CONV_SHAPES[name][4])
    return torch.relu(y) if relu else y


def bottleneck(params, x: torch.Tensor, stage: int, block: int) -> torch.Tensor:
    """One bottleneck of ``params``: ``relu(conv3(relu(conv2(relu(conv1(x)))))
    + shortcut(x))``."""
    pre = f"layer{stage}.{block}."
    y = _c(params, pre + "conv2", _c(params, pre + "conv1", x))
    y = _c(params, pre + "conv3", y, relu=False)
    sc = _c(params, pre + "downsample", x, relu=False) if block == 0 else x
    return torch.relu(y + sc)


def stage_forward(params, x: torch.Tensor, stage: int) -> torch.Tensor:
    for b in range(STAGES[stage - 1][0]):
        x = bottleneck(params, x, stage, b)
    return x


def stem(params, x: torch.Tensor) -> torch.Tensor:
    """conv1: the 7x7 stride-2 stem and its ReLU."""
    return _c(params, "conv1", x)


def extract_features(
    params: Mapping[str, Mapping[str, torch.Tensor]],
    x: torch.Tensor,
    layers: Sequence[str],
    *,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run ResNet-50 on a preprocessed NHWC input; returns the requested
    activations (:data:`LAYER_NAMES`) in ``compute_dtype``, the forward run
    to the deepest of them. ``remat=True`` checkpoints each stage."""
    if not layers:
        raise ValueError("no layers requested")
    stop = deepest_layer(layers)
    wanted = set(layers)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    feats: Dict[str, torch.Tensor] = {}
    x = stem(params, x)
    if "conv1" in wanted:
        feats["conv1"] = x
    if stop == "conv1":
        return feats
    x = max_pool(x)
    for s in range(1, len(STAGES) + 1):
        if remat:
            x = torch.utils.checkpoint.checkpoint(stage_forward, params, x, s, use_reentrant=False,
                                                  preserve_rng_state=False)
        else:
            x = stage_forward(params, x, s)
        name = f"layer{s}"
        if name in wanted:
            feats[name] = x
        if name == stop:
            break
    return feats


#: bf16 columns a pixel of the stem's im2col operand takes (7 x 7 x 3 = 147
#: padded to a multiple of 8).
STEM_COLUMNS = 152


def peak_bytes_per_pixel() -> float:
    """Bytes the kernel route holds at its peak, per pixel of the input
    image: what a forward keeps for its backward (the stem's bf16 output at
    1/4 of the pixels and its max pool's int8 window indices at 1/16, each
    bottleneck's two inner bf16 activations and its output at their own
    extents), and the largest transient beside it, the stem's im2col
    operand or its cotangent (:data:`STEM_COLUMNS` bf16 at 1/4). The
    auto-remat threshold of ``api`` divides the card's budget by it."""
    total = 2 * STEM_CHANNELS / 4 + STEM_CHANNELS / 16 + 2 * STEM_COLUMNS / 4
    area = 1 / 16
    for n, width, stride in STAGES:
        for b in range(n):
            inner = area
            if b == 0 and stride == 2:
                area = area / 4
            total += 2 * (width * inner + width * area + width * EXPANSION * area)
    return total
