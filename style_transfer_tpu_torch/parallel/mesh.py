"""Device mesh and spatial sharding (PyTorch port).

Counterpart of ``style_transfer_tpu/parallel/mesh.py``. The reference is
single-process SPMD: a 1-D ``jax.sharding.Mesh`` on the axis ``"space"``,
images and activations split along H, weights and Gram targets replicated,
and ``shard_map`` wrappers that give each Pallas kernel its ``ppermute``
halo rows and ``psum`` its Grams. The port keeps the one-process model: a
:class:`Mesh` is an ordered tuple of ``torch.device`` s that one Python
process drives. Halo rows move by device-to-device copies
(``.to(device, non_blocking=True)``, ordered by the streams, so no copy
makes the host wait) and partial Grams are summed on one device. There is
no ``torch.distributed``: NCCL refuses two ranks on one GPU, and a mesh
that repeats one card (``[cuda:0] * 8``) runs every shard's kernels, halos
and reductions as a mesh of eight cards would, with only the copies staying
on one device. On the CPU, a mesh of N CPU shards plays the part of the
JAX tests' forced CPU devices.

What is sharded: every VGG activation and all of the VGG's forward and
backward work (``ops/kernels``' ``make_sharded_*`` wrappers and
``models.vgg.extract_features_sharded``). What is not: the image, its
gradient, the optimizer state, the EMA, the pipelined chunk records, the TV
loss and the scalar losses stay on the mesh's first device, the *home*
device. The objective moves the preprocessed image onto the shards
(:func:`scatter_rows`) and brings the Grams and content SSEs back
(:func:`all_reduce_to`); autograd carries the gradient home. This departs
from the reference, which shards the image and Adam's moments too: the port
shards what dominates memory (the chain's stored activations, hundreds of
MiB per megapixel, against 12 bytes per pixel for each image-sized fp32
buffer), and the optimizer state can follow if the home device's share
ever binds.

Shard boundaries (:func:`row_bounds`) lie at multiples of
:data:`ROW_GRAIN` image rows, so every shard starts on an even row at each
of the four pool levels before conv5_1; a height that is not a multiple of
the grain only lengthens the last shard. There is no halo at the image's
edge: an edge shard's kernel pads with zeros, which is exactly SAME
padding. (The TPU kernels instead take zero-filled halo rows and turn them
into padding with global row masks; the port's kernels have no such masks,
and a zero-filled row is not padding after the first conv, where it becomes
``relu(bias)``.)
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SPATIAL_AXIS = "space"

#: Shard boundaries lie at multiples of this many image rows: 2^4, so each
#: shard starts on an even row at every pool before conv5_1.
ROW_GRAIN = 16


def canonical_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh of devices on :data:`SPATIAL_AXIS`; a device may
    repeat. Shard ``i`` of an H-sharded tensor lives on ``devices[i]``; the
    first device is the home of everything that is not sharded."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(canonical_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    axis_names = (SPATIAL_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def take(self, n: int) -> "Mesh":
        """The mesh of the first ``n`` devices."""
        return Mesh(self.devices[:n])


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``devices``, or over the first ``n_devices`` CUDA
    devices (default: all visible ones). Explicit lists may repeat a device
    (``["cpu"] * 8``, ``["cuda:0"] * 8``)."""
    if devices is None:
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n > have:
            raise ValueError(f"asked for {n} devices, have {have}")
        if n < 1:
            raise ValueError(f"a mesh needs at least one device, got {n} (CUDA devices: {have})")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(devices))


def shard_count(h: int, n: int) -> int:
    """How many of ``n`` devices an image of ``h`` rows uses: one per
    :data:`ROW_GRAIN` rows at most, and at least one."""
    return max(1, min(n, h // ROW_GRAIN))


def row_bounds(h: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """``((lo, hi), ...)``: the image rows of each of :func:`shard_count`
    shards. Boundaries lie at multiples of :data:`ROW_GRAIN`, the grains are
    spread as evenly as they go (the first shards take one more), and the
    rows beyond the last whole grain go to the last shard."""
    k = shard_count(h, n)
    if k == 1:
        return ((0, h),)
    base, extra = divmod(h // ROW_GRAIN, k)
    edges = [0]
    for i in range(k):
        edges.append(edges[-1] + (base + (i < extra)) * ROW_GRAIN)
    edges[-1] = h
    return tuple(zip(edges[:-1], edges[1:]))


def rows_of(shards: Sequence[torch.Tensor]) -> List[int]:
    """Rows (dim 1) of each shard."""
    return [int(s.shape[1]) for s in shards]


def pixels_per_device(bounds: Sequence[Tuple[int, int]], w: int, mesh: Mesh) -> int:
    """The most pixels of an (H, w) image's activations that one device of
    ``mesh`` holds when sharded on ``bounds`` (a repeated device holds all
    of its shards): the count the reference writes ``H * W // n_dev``."""
    per: Dict[torch.device, int] = {}
    for (lo, hi), dev in zip(bounds, mesh.devices):
        per[dev] = per.get(dev, 0) + (hi - lo) * w
    return max(per.values())


# ---------------------------------------------------------------- replicas

#: Most per-device copies kept (least recently used out first).
MAX_REPLICAS = 1024

_replicas: "OrderedDict[tuple, tuple]" = OrderedDict()


def replica(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: ``t`` itself where it already lies there, else a
    copy made once per tensor and device (keyed as ``ops/kernels/_weights``
    keys its preparations; the entry keeps the source alive). A mesh that
    repeats one device therefore shares one copy, and shares the kernels'
    prepared-weight cache entry with it."""
    if t.device == device:
        return t
    key = (t.data_ptr(), t._version, tuple(t.shape), t.stride(), t.dtype, str(t.device),
           str(device))
    hit = _replicas.get(key)
    if hit is not None:
        _replicas.move_to_end(key)
        return hit[1]
    with torch.no_grad():
        out = t.to(device)
    _replicas[key] = (t, out)
    while len(_replicas) > MAX_REPLICAS:
        _replicas.popitem(last=False)
    return out


def replicas(device: torch.device, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """:func:`replica` of each tensor on ``device``."""
    return [replica(t, device) for t in tensors]


def replicate(tree: Dict[str, Dict[str, torch.Tensor]], mesh: Mesh):
    """``{device: tree}``: the ``{layer: {name: tensor}}`` params on each
    distinct device of ``mesh`` (one copy a device, made and cached now)."""
    return {dev: {layer: {k: replica(v, dev) for k, v in p.items()} for layer, p in tree.items()}
            for dev in mesh.distinct()}


# ------------------------------------------------- moving rows between devices


class _Scatter(torch.autograd.Function):
    """Rows ``[lo, hi)`` of an (N, H, ...) tensor to each shard's device;
    the backward concatenates the shards' cotangents on the source's device."""

    @staticmethod
    def forward(ctx, x, bounds, devices):
        ctx.device, ctx.shape, ctx.dtype = x.device, x.shape, x.dtype
        ctx.bounds = bounds
        return tuple(x[:, lo:hi].to(dev, non_blocking=True)
                     for (lo, hi), dev in zip(bounds, devices))

    @staticmethod
    def backward(ctx, *grads):
        parts = []
        for g, (lo, hi) in zip(grads, ctx.bounds):
            if g is None:
                shape = (ctx.shape[0], hi - lo) + tuple(ctx.shape[2:])
                g = torch.zeros(shape, dtype=ctx.dtype, device=ctx.device)
            parts.append(g.to(ctx.device, non_blocking=True))
        return torch.cat(parts, dim=1), None, None


def scatter_rows(x: torch.Tensor, bounds: Sequence[Tuple[int, int]], mesh: Mesh
                 ) -> List[torch.Tensor]:
    """Shard ``i`` = ``x[:, lo_i:hi_i]`` on ``mesh.devices[i]``;
    differentiable (the cotangent comes back as one tensor on ``x``'s
    device, with no full-size buffer per shard)."""
    if len(bounds) > mesh.size:
        raise ValueError(f"{len(bounds)} shards on a mesh of {mesh.size} devices")
    return list(_Scatter.apply(x, tuple(bounds), mesh.devices[:len(bounds)]))


def gather_rows(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards concatenated along H on ``device`` (differentiable). Not
    used on the objective's path, which never gathers an activation."""
    device = canonical_device(device)
    return torch.cat([s.to(device, non_blocking=True) for s in shards], dim=1)


class _Halo(torch.autograd.Function):
    """Each shard extended by ``up`` rows of the shard before it and
    ``down`` rows of the shard after it (none at the image's edge). The
    backward sends each halo row's cotangent back to the shard that owns it
    and adds it to the owner's own cotangent in fp32 (at least), rounding
    once to the shard's dtype."""

    @staticmethod
    def forward(ctx, up, down, *shards):
        n = len(shards)
        ctx.up, ctx.down = up, down
        ctx.meta = [(s.shape, s.dtype, s.device) for s in shards]
        ctx.set_materialize_grads(False)
        out = []
        for i, s in enumerate(shards):
            parts = []
            if i > 0 and up:
                parts.append(shards[i - 1][:, -up:].to(s.device, non_blocking=True))
            parts.append(s)
            if i < n - 1 and down:
                parts.append(shards[i + 1][:, :down].to(s.device, non_blocking=True))
            out.append(torch.cat(parts, dim=1))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n, up, down = len(grads), ctx.up, ctx.down
        res = []
        for i, (shape, dtype, dev) in enumerate(ctx.meta):
            own, u = shape[1], (up if i > 0 else 0)
            top = down if i > 0 else 0  # my first rows, sent down to shard i-1
            bot = up if i < n - 1 else 0  # my last rows, sent up to shard i+1
            prev = grads[i - 1] if top else None
            nxt = grads[i + 1] if bot else None
            g = grads[i]
            if g is None and prev is None and nxt is None:
                res.append(None)
                continue
            acc_t = torch.promote_types(dtype, torch.float32)
            if g is None:
                base = torch.zeros(shape, dtype=dtype, device=dev)
            else:
                base = g[:, u:u + own]
            if prev is None and nxt is None:
                res.append(base)
                continue
            parts = [] if prev is None else [(0, top, prev[:, prev.shape[1] - top:])]
            if nxt is not None:
                parts.append((own - bot, own, nxt[:, :bot]))
            out = base.clone(memory_format=torch.contiguous_format)
            if top and bot and top + bot > own:  # the two halo spans overlap: one fp32 sum
                acc = base.to(acc_t)
                for lo, hi, p in parts:
                    acc[:, lo:hi] += p.to(dev, non_blocking=True).to(acc_t)
                out = acc.to(dtype)
            else:
                for lo, hi, p in parts:
                    out[:, lo:hi] = (base[:, lo:hi].to(acc_t)
                                     + p.to(dev, non_blocking=True).to(acc_t)).to(dtype)
            res.append(out)
        return (None, None) + tuple(res)


def with_halo(shards: Sequence[torch.Tensor], up: int, down: int) -> List[torch.Tensor]:
    """Every shard's rows with ``up`` rows of the shard before it and
    ``down`` rows of the shard after it, on the shard's own device; an edge
    shard gets no rows beyond the image. Differentiable: a halo row's
    cotangent goes back to its owner and is summed there in fp32 with the
    owner's own, rounded once (``torch.cat``'s autograd would add bf16
    partials in bf16). It takes all shards at once because that sum needs
    every partial of a row in one backward. A neighbour with fewer rows
    than the halo raises."""
    shards = list(shards)
    n = len(shards)
    if n == 1 or (up == 0 and down == 0):
        return shards
    for i, s in enumerate(shards):
        need = max(down if i > 0 else 0, up if i < n - 1 else 0)
        if s.shape[1] < need:
            raise ValueError(f"shard {i} has {s.shape[1]} rows, fewer than the {need}-row halo "
                             f"its neighbours need (rows {rows_of(shards)})")
    return list(_Halo.apply(up, down, *shards))


def all_reduce_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts`` (partial Grams or SSEs) on ``device``, added in
    shard order; differentiable (each part's cotangent goes back to its
    device)."""
    device = canonical_device(device)
    total = None
    for p in parts:
        p = p.to(device, non_blocking=True)
        total = p if total is None else total + p
    return total


def map_shards(fn, xs: Sequence[torch.Tensor], halo: int, *, pool: bool, gram: bool,
               out: bool = True, home) -> object:
    """Runs a kernel on every shard's rows extended by ``halo`` rows each
    way: ``fn(x_ext, device, gram_rows, hw)`` with ``gram_rows = (lo, hi)``
    the shard's own rows within ``x_ext`` and ``hw`` the global H*W. Keeps
    each shard's own output rows (pooled rows halve; ``halo`` must then be
    even) and all-reduces the Grams on ``home``. Returns what the
    unsharded form returns, with a list of shards in place of each
    activation: ``outs``, ``(outs, gram)`` or, with ``out=False``, ``gram``."""
    xs = list(xs)
    if pool and (halo % 2 or any(r % 2 for r in rows_of(xs)[:-1])):
        raise ValueError(f"pooled shards need even rows before the last and an even halo, "
                         f"got rows {rows_of(xs)} and halo {halo}")
    ext = with_halo(xs, halo, halo)
    hw = sum(rows_of(xs)) * int(xs[0].shape[2])
    outs, grams = [], []
    for i, (x, e) in enumerate(zip(xs, ext)):
        up, own = (halo if i > 0 else 0), int(x.shape[1])
        r = fn(e, x.device, (up, up + own), hw)
        if gram:
            o, g = r if out else (None, r)
            grams.append(g)
        else:
            o = r
        if out:
            outs.append(o[:, up // 2:(up + own) // 2] if pool else o[:, up:up + own])
    if not gram:
        return outs
    g = all_reduce_to(grams, home)
    return (outs, g) if out else g
