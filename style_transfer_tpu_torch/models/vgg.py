"""VGG-19/VGG-16 feature extractor on NHWC tensors (PyTorch port).

Counterpart of ``style_transfer_tpu/models/vgg.py`` (``blocks``,
``conv_names``, ``layer_channels``, ``init_params``, ``infer_arch``,
``_conv``, ``_pool``, ``extract_features``, the ``VGG`` class and the
VGG-19 constants). The layouts stay the JAX
package's: NHWC activations, HWIO kernels, and params as a plain
``{layer: {"kernel", "bias"}}`` dict of tensors, so the port and the
reference compare like with like. Convolutions go through ``F.conv2d`` on a
channels-last view (this is the plain path; the fused path runs the
hand-written kernels of ``ops/kernels``).

``remat=True`` checkpoints each conv block with a non-reentrant
``torch.utils.checkpoint.checkpoint``, the counterpart of the reference's
``jax.checkpoint(block_fn)``.

:func:`extract_features_sharded` is the same forward on a list of H shards
(``parallel/mesh.py``): the layers a mesh runs outside the kernel chain
(odd extents, non-default layers, ``use_fused=False``). Each conv takes one
halo row of each neighbour, each pool takes the rows of its pairs. The
reference's ``shard_divisor`` switch (``vgg.py:143-180``), which pools by
slicing to work around an XLA SPMD miscompile of the reshape pool's
backward, has no counterpart: the port pools each shard itself.

``init_params`` draws He-normal weights from ``numpy.random.RandomState``,
so its values differ from the JAX package's ``jax.random`` fixture; parity
tests pass the JAX fixture over with ``weights.from_numpy_params``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from style_transfer_tpu_torch.parallel import mesh as M

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


# VGG-19 module-level constants (the default family, used by most callers).
CONV_NAMES: tuple = conv_names()
POOL_NAMES: tuple = tuple(f"pool{b}" for b, _, _ in blocks())
LAYER_NAMES: tuple = layer_names()
LAYER_CHANNELS: Dict[str, int] = layer_channels()


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
    remat: bool = False,
    start_block: int = 1,
    start_conv: int = 0,
) -> Dict[str, torch.Tensor]:
    """Run a VGG variant on preprocessed NHWC input; returns the requested
    post-ReLU activations (and pool outputs) in ``compute_dtype``.

    ``start_block > 1`` treats ``x`` as the pooled output of block
    ``start_block - 1``; ``start_conv > 0`` as the post-ReLU output of that
    many convs within the start block — the seams where the fused kernels
    hand over. The forward stops at the deepest requested layer.

    ``remat=True`` checkpoints each conv *block*: between forward and
    backward only block boundaries and requested activations stay live, and
    each block's backward recomputes just that block's interior. Blockwise
    is the reference's grain (``vgg.py:241-246``): one checkpoint around the
    whole extractor re-stores every activation during its one recompute.
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
        names = [f"conv{b}_{i}" for i in range(skip + 1, n + 1)]
        pool_name = f"pool{b}"
        block_stop = stop if (stop in names or stop == pool_name) else None

        def block_fn(x, names=names, pool_name=pool_name, block_stop=block_stop):
            bf: Dict[str, torch.Tensor] = {}
            for name in names:
                p = params[name]
                x = torch.relu(conv3x3(x, p["kernel"], p["bias"]))
                if name in wanted:
                    bf[name] = x
                if name == block_stop:
                    return x, bf
            x = pool2x2(x, pooling)
            if pool_name in wanted:
                bf[pool_name] = x
            return x, bf

        if remat:
            x, block_feats = torch.utils.checkpoint.checkpoint(
                block_fn, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, block_feats = block_fn(x)
        feats.update(block_feats)
        if block_stop is not None:
            return feats
    return feats


def _conv_shards(xs, kernel, bias):
    """relu(conv3x3) of every shard, each over its rows plus one halo row of
    each neighbour, keeping its own rows."""
    ext = M.with_halo(xs, 1, 1)
    out = []
    for i, (x, e) in enumerate(zip(xs, ext)):
        up, own = (1 if i > 0 else 0), x.shape[1]
        y = torch.relu(conv3x3(e, *M.replicas(x.device, kernel, bias)))
        out.append(y[:, up:up + own])
    return out


def _pool_shards(xs, mode: str):
    """:func:`pool2x2` of the image the shards make up, shard by shard:
    pooled row j pairs rows 2j and 2j+1, so a shard whose first row is odd
    leaves it to the shard before, which takes it as one halo row. The
    pooled shard ``[lo, hi)`` becomes ``[ceil(lo/2), ceil(hi/2))``; an odd
    last row at the image's edge pools as :func:`pool2x2` pools it. The
    chain's row bounds (``mesh.row_bounds``) start every shard on an even
    row before conv5_1, where no halo is needed."""
    rows = M.rows_of(xs)
    starts = [sum(rows[:i]) for i in range(len(rows))]
    if not any(s % 2 for s in starts):
        return [pool2x2(x, mode) for x in xs]
    ext = M.with_halo(xs, 0, 1)
    out = []
    for i, (x, e, lo) in enumerate(zip(xs, ext, starts)):
        end = rows[i] + (1 if (lo + rows[i]) % 2 and i < len(xs) - 1 else 0)
        out.append(pool2x2(e[:, lo % 2:end], mode))
    return out


def extract_features_sharded(
    params: Mapping[str, Mapping[str, torch.Tensor]],
    xs: Sequence[torch.Tensor],
    layers: Sequence[str],
    *,
    pooling: str = "average",
    compute_dtype: Optional[torch.dtype] = None,
    arch: str = DEFAULT_ARCH,
    remat: bool = False,
    start_block: int = 1,
    start_conv: int = 0,
) -> Dict[str, list]:
    """:func:`extract_features` on a list of H shards, one per mesh device
    (``parallel/mesh.py``): returns each requested activation as a list of
    shards. Each conv runs per shard over its rows plus one halo row of each
    neighbour (``mesh.with_halo``), so no activation is ever gathered. The
    weights reach each shard's device through ``mesh.replica``. ``remat``
    checkpoints each block as :func:`extract_features` does."""
    if not layers:
        raise ValueError("no layers requested")
    wanted = set(layers)
    stop = deepest_layer(layers, arch)
    xs = list(xs)
    if compute_dtype is not None:
        xs = [x.to(compute_dtype) for x in xs]

    feats: Dict[str, list] = {}
    for b, n, _ in blocks(arch):
        if b < start_block:
            continue
        skip = start_conv if b == start_block else 0
        names = [f"conv{b}_{i}" for i in range(skip + 1, n + 1)]
        pool_name = f"pool{b}"
        block_stop = stop if (stop in names or stop == pool_name) else None

        def block_fn(*xs, names=names, pool_name=pool_name, block_stop=block_stop):
            bf: Dict[str, list] = {}
            xs = list(xs)
            for name in names:
                xs = _conv_shards(xs, params[name]["kernel"], params[name]["bias"])
                if name in wanted:
                    bf[name] = xs
                if name == block_stop:
                    return xs, bf
            xs = _pool_shards(xs, pooling)
            if pool_name in wanted:
                bf[pool_name] = xs
            return xs, bf

        if remat:
            xs, block_feats = torch.utils.checkpoint.checkpoint(
                block_fn, *xs, use_reentrant=False, preserve_rng_state=False)
        else:
            xs, block_feats = block_fn(*xs)
        feats.update(block_feats)
        if block_stop is not None:
            return feats
    return feats


class VGG(torch.nn.Module):
    """Params, pooling and compute dtype bound into a module (JAX ``VGG``,
    ``vgg.py:288-317``). The weights are buffers, not parameters: ``.to()``
    moves them, and they take no gradient, which is the image optimization's
    frozen-weights contract. ``arch`` is inferred from the parameter keys.
    ``forward(x, layers)`` is :func:`extract_features`, the plain path, as
    the JAX class's ``__call__`` is; the kernel chain runs only inside
    ``StyleTransfer``."""

    def __init__(self, params: Mapping[str, Mapping[str, torch.Tensor]], *,
                 pooling: str = "average", compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.arch = infer_arch(params)
        self.pooling = pooling
        self.compute_dtype = compute_dtype
        for name in conv_names(self.arch):
            for k in ("kernel", "bias"):
                self.register_buffer(f"{name}_{k}", torch.as_tensor(params[name][k]).detach())

    @property
    def params(self) -> Params:
        """The weights as a ``{layer: {"kernel", "bias"}}`` dict of the
        module's buffers (wherever ``.to()`` has moved them)."""
        return {name: {k: getattr(self, f"{name}_{k}") for k in ("kernel", "bias")}
                for name in conv_names(self.arch)}

    def forward(self, x: torch.Tensor, layers: Sequence[str]) -> Dict[str, torch.Tensor]:
        return extract_features(self.params, x, layers, pooling=self.pooling,
                                compute_dtype=self.compute_dtype, arch=self.arch)

    @classmethod
    def random(cls, seed: int = 0, arch: str = DEFAULT_ARCH, **kw) -> "VGG":
        """A module on :func:`init_params`' numpy draw: its values differ from
        the JAX ``VGG.random`` of the same seed (module docstring)."""
        return cls(init_params(seed, arch), **kw)


#: Backwards-compatible alias (the default family).
VGG19 = VGG


# Classic Gatys selections (``vgg.py:323-324``).
DEFAULT_CONTENT_LAYERS = ("conv4_2",)
DEFAULT_STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
