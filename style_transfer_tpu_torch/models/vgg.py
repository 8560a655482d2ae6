"""VGG-19/VGG-16 feature extractor on NHWC tensors (PyTorch port).

Counterpart of ``style_transfer_tpu/models/vgg.py`` (``blocks``,
``conv_names``, ``layer_channels``, ``init_params``, ``infer_arch``,
``_conv``, ``_pool``, ``extract_features``). The layouts stay the JAX
package's: NHWC activations, HWIO kernels, and params as a plain
``{layer: {"kernel", "bias"}}`` dict of tensors, so the port and the
reference compare like with like. Convolutions go through ``F.conv2d`` on a
channels-last view (this is the plain path; the fused path runs the
hand-written kernels of ``ops/kernels``).

Left out: ``shard_divisor`` and the SPMD slice-pool variant (spatial meshes
are not ported yet), ``remat`` (``jax.checkpoint`` per block), and the
``VGG`` convenience class.

``init_params`` draws He-normal weights from ``numpy.random.RandomState``,
so its values differ from the JAX package's ``jax.random`` fixture; parity
tests pass the JAX fixture over with ``weights.from_numpy_params``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

ARCH_BLOCKS: Dict[str, tuple] = {
    "vgg19": (2, 2, 4, 4, 4),
    "vgg16": (2, 2, 3, 3, 3),
}
_WIDTHS = (64, 128, 256, 512, 512)
DEFAULT_ARCH = "vgg19"

Params = Dict[str, Dict[str, torch.Tensor]]


def blocks(arch: str = DEFAULT_ARCH) -> tuple:
    """((block_index, convs_in_block, channels), ...) for an architecture."""
    try:
        nconvs = ARCH_BLOCKS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; supported: {sorted(ARCH_BLOCKS)}")
    return tuple((b + 1, n, _WIDTHS[b]) for b, n in enumerate(nconvs))


def conv_names(arch: str = DEFAULT_ARCH) -> tuple:
    return tuple(f"conv{b}_{i}" for b, n, _ in blocks(arch) for i in range(1, n + 1))


def layer_names(arch: str = DEFAULT_ARCH) -> tuple:
    """All capturable activation names, in forward order."""
    return tuple(
        name
        for b, n, _ in blocks(arch)
        for name in [f"conv{b}_{i}" for i in range(1, n + 1)] + [f"pool{b}"]
    )


def layer_channels(arch: str = DEFAULT_ARCH) -> Dict[str, int]:
    """Output channel count of every capturable layer."""
    out: Dict[str, int] = {}
    for b, n, c in blocks(arch):
        for i in range(1, n + 1):
            out[f"conv{b}_{i}"] = c
        out[f"pool{b}"] = c
    return out


LAYER_NAMES: tuple = layer_names()


def conv_in_channels(name: str, arch: str = DEFAULT_ARCH) -> int:
    """Input channel count of a conv layer."""
    names = conv_names(arch)
    idx = names.index(name)
    if idx == 0:
        return 3
    return layer_channels(arch)[names[idx - 1]]


def init_params(seed: int = 0, arch: str = DEFAULT_ARCH) -> Params:
    """He-normal random VGG parameters from ``numpy.random.RandomState(seed)``
    (float32, CPU). Not the JAX fixture's values: see the module docstring."""
    rng = np.random.RandomState(seed)
    channels = layer_channels(arch)
    params: Params = {}
    for name in conv_names(arch):
        cin, cout = conv_in_channels(name, arch), channels[name]
        std = np.sqrt(2.0 / (3 * 3 * cin))
        kernel = (rng.standard_normal((3, 3, cin, cout)) * std).astype(np.float32)
        params[name] = {
            "kernel": torch.from_numpy(kernel),
            "bias": torch.zeros((cout,), dtype=torch.float32),
        }
    return params


def infer_arch(params: Mapping[str, object]) -> str:
    """Which supported architecture a parameter dict belongs to."""
    keys = set(params.keys())
    for arch in ARCH_BLOCKS:
        if keys == set(conv_names(arch)):
            return arch
    raise ValueError(
        f"parameter keys match no supported arch {sorted(ARCH_BLOCKS)}: "
        f"{sorted(keys)[:6]}..."
    )


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC input and HWIO kernel, in the input's dtype; the
    bias is added after the conv in that dtype, as the JAX ``_conv`` does."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2),
        kernel.to(x.dtype).permute(3, 2, 0, 1),
        padding=1,
    )
    return y.permute(0, 2, 3, 1) + bias.to(x.dtype)


def pool2x2(x: torch.Tensor, mode: str = "average") -> torch.Tensor:
    """2x2 stride-2 pooling of an NHWC tensor. An odd edge copies its last
    row/column first, which for a 2x2 window reproduces exclude-padding
    averaging (``vgg.py::_pool``)."""
    n, h, w, c = x.shape
    if h % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
        h += 1
    if w % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
        w += 1
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    if mode == "average":
        return x.mean(dim=(2, 4))
    if mode == "max":
        return x.amax(dim=(2, 4))
    raise ValueError(f"unknown pooling mode {mode!r}")


def deepest_layer(layers: Iterable[str], arch: str = DEFAULT_ARCH) -> str:
    """The forward-order-latest of ``layers``."""
    names = layer_names(arch)
    order = {n: i for i, n in enumerate(names)}
    layers = list(layers)
    for name in layers:
        if name not in order:
            raise ValueError(f"unknown {arch} layer {name!r}; valid: {names}")
    return max(layers, key=order.__getitem__)


def extract_features(
    params: Mapping[str, Mapping[str, torch.Tensor]],
    x: torch.Tensor,
    layers: Sequence[str],
    *,
    pooling: str = "average",
    compute_dtype: Optional[torch.dtype] = None,
    arch: str = DEFAULT_ARCH,
    start_block: int = 1,
    start_conv: int = 0,
) -> Dict[str, torch.Tensor]:
    """Run a VGG variant on preprocessed NHWC input; returns the requested
    post-ReLU activations (and pool outputs) in ``compute_dtype``.

    ``start_block > 1`` treats ``x`` as the pooled output of block
    ``start_block - 1``; ``start_conv > 0`` as the post-ReLU output of that
    many convs within the start block — the seams where the fused kernels
    hand over. The forward stops at the deepest requested layer.
    """
    if not layers:
        raise ValueError("no layers requested")
    wanted = set(layers)
    stop = deepest_layer(layers, arch)
    if compute_dtype is not None:
        x = x.to(compute_dtype)

    feats: Dict[str, torch.Tensor] = {}
    for b, n, _ in blocks(arch):
        if b < start_block:
            continue
        skip = start_conv if b == start_block else 0
        for name in [f"conv{b}_{i}" for i in range(skip + 1, n + 1)]:
            p = params[name]
            x = torch.relu(conv3x3(x, p["kernel"], p["bias"]))
            if name in wanted:
                feats[name] = x
            if name == stop:
                return feats
        x = pool2x2(x, pooling)
        if f"pool{b}" in wanted:
            feats[f"pool{b}"] = x
        if f"pool{b}" == stop:
            return feats
    return feats


# Classic Gatys selections (``vgg.py:323-324``).
DEFAULT_CONTENT_LAYERS = ("conv4_2",)
DEFAULT_STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
