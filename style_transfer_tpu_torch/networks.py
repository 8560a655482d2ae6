"""Each architecture's forward, planned once per image extent.

``StyleTransfer`` picks its network once (:data:`NETWORKS`, by the
architecture ``models.infer_arch`` reads off the parameter keys) and only
calls it: ``plan`` decides every route of a forward from the image's (H, W),
the requested layers and the configuration's switches, and ``run`` executes
the :class:`Plan`. Nothing else enters a plan, so the objective makes one
per scale. A new architecture is a class here and its entry there.

VGG is the JAX fused chain (``api.py:644-918``): blocks 1 and 2, the block-3
and block-4 front/tail segments and the conv5_1 Gram tail, each joining
while its gate holds, each segment's form from the size rule of
``ops/kernels/dispatch.py``, and the plain ``vgg.extract_features`` from
the seam for what the chain does not carry; on a mesh, the sharded forms.
ResNet-50 runs its stem and max pool, then each stage up to the deepest
requested layer, on ``ops/kernels/resnet.py``.

A plan is full when the kernels carry every requested layer: they keep bf16
residuals and masks for the backward, the plain path more, so a full plan
has its network's own auto-remat threshold (``remat_auto_pixels``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch.utils.checkpoint

from style_transfer_tpu_torch.models import resnet
from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import dispatch
from style_transfer_tpu_torch.ops.kernels import resnet as RK
from style_transfer_tpu_torch.parallel import mesh as M


@dataclasses.dataclass(frozen=True)
class Segment:
    """One kernel call of a plan: ``fn(handoff, *operands)``, the operands
    being the kernel and bias of each layer of ``weights``, or the whole
    parameter dict for ``weights=None``. Its first output is the next
    segment's handoff; ``keep`` names the outputs the forward returns, as
    ``(output index, "feats" or "grams", layer)``."""

    fn: Callable
    weights: Optional[Tuple[str, ...]]
    keep: Tuple[Tuple[int, str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class Tail:
    """The plain forward of the requested ``layers`` the segments do not
    carry, from the handoff at ``start_block`` / ``start_conv``
    (``vgg.extract_features``' seam)."""

    layers: Tuple[str, ...]
    start_block: int = 1
    start_conv: int = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """The routes of one forward: the kernel calls in order, the plain tail
    (None when the kernels carry every requested layer) and ``route``, the
    ``(segment, form)`` pairs ``StyleTransfer.last_route`` reports."""

    segments: Tuple[Segment, ...]
    tail: Optional[Tail]
    route: Tuple[Tuple[str, str], ...]

    @property
    def full(self) -> bool:
        """Whether no requested layer reaches the plain path."""
        return self.tail is None


def _checkpointed(fn):
    """``fn`` under a non-reentrant checkpoint: its forward runs again in the
    backward. The kernels draw no random numbers, so no RNG state is kept."""
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def _union(content_layers, style_layers) -> Tuple[str, ...]:
    return tuple(dict.fromkeys(tuple(content_layers) + tuple(style_layers)))


def _kept(kind: str, layer: str, wanted, index: int = 1):
    return ((index, kind, layer),) if layer in wanted else ()


class _Network:
    """What the networks share: :meth:`run`. A subclass gives ``pooling``,
    ``remat_auto_pixels``, ``plan`` and ``_plain`` (its plain forward)."""

    def run(self, plan: Plan, x, params, remat: bool = False):
        """``(feats, grams)`` of the preprocessed image ``x`` (on a mesh, its
        list of row shards) by ``plan``: the requested activations, as lists
        of shards on a mesh, and the Grams the kernels made. ``remat`` runs
        each kernel call under a checkpoint (JAX ``api.py:664``) and the
        plain tail checkpoints each block."""
        feats: Dict[str, object] = {}
        grams: Dict[str, object] = {}
        out = {"feats": feats, "grams": grams}
        for seg in plan.segments:
            fn = _checkpointed(seg.fn) if remat else seg.fn
            operands = ((params,) if seg.weights is None else
                        [t for n in seg.weights for t in (params[n]["kernel"], params[n]["bias"])])
            y = fn(x, *operands)
            y = y if isinstance(y, tuple) else (y,)
            for i, kind, layer in seg.keep:
                out[kind][layer] = y[i]
            x = y[0]
        if plan.tail is not None:
            feats.update(self._plain(plan.tail, x, params, remat))
        return feats, grams


#: Pixels per device from which ``remat=None`` turns remat on for a full
#: VGG plan: where the peak of one stored-path scale of configuration 2's
#: flags, measured on the H100 at 2048^2 and 4096^2 (3258.5 and 12220.3
#: MiB; ``chip_smoke.py``, phase cli, part remat_fit) and fit as linear
#: in pixels, reaches 75% of the card's 80 GB (as ``api.REMAT_AUTO_PIXELS``
#: does on the plain path). At 4096^2 remat lowered the chain's peak by
#: 3% only: block 1's backward transients, which it keeps, set it.
REMAT_AUTO_PIXELS_FUSED = 79_960_000


class VGG(_Network):
    """VGG-19 or VGG-16 (module docstring). ``pooling=None`` is average."""

    remat_auto_pixels = REMAT_AUTO_PIXELS_FUSED

    def __init__(self, arch: str, *, pooling: Optional[str] = None,
                 mesh: Optional[M.Mesh] = None):
        self.arch, self.mesh = arch, mesh
        self.pooling = "average" if pooling is None else pooling
        self._blocks = {b: n for b, n, _ in vgg.blocks(arch)}

    def _clear(self, b: int, content: set, style: set, layers) -> bool:
        """Block ``b``'s gate on the layers: none of its layers is content,
        none but its first conv is style (that one's Gram comes out of the
        kernel), and a deeper layer is requested."""
        names = [f"conv{i}_{j}" for i in range(1, b + 1) for j in range(1, self._blocks[i] + 1)]
        shallow = set(names) | {f"pool{i}" for i in range(1, b + 1)}
        block = {l for l in shallow if l.startswith((f"conv{b}_", f"pool{b}"))}
        return (not content & block and not style & (block - {f"conv{b}_1"})
                and any(l not in shallow for l in layers))

    def plan(self, h: int, w: int, content_layers, style_layers, *, fused: bool,
             fused_block1: bool, config_layers) -> Plan:
        """The routes of a forward of an (h, w) image computing
        ``content_layers`` and ``style_layers``: the chain under ``fused``,
        ``block1_full`` when ``fused_block1`` also holds and no mesh is set
        (engaged on ``config_layers``, the configuration's ``(content,
        style)``), else the plain path."""
        layers = _union(content_layers, style_layers)
        mesh = None if self.mesh is None else self.mesh.take(M.shard_count(h, self.mesh.size))
        content, style = set(content_layers), set(style_layers)
        full1 = fused_block1 and mesh is None  # block1_full takes precedence over the chain
        c, s = config_layers if full1 else (content_layers, style_layers)
        if (not fused or self.pooling != "average" or h % 2 or w % 2
                or not self._clear(1, set(c), set(s), _union(c, s))):
            return Plan((), Tail(layers), (("vgg", "plain" if mesh is None else "plain_sharded"),))
        if full1:
            b1, form = B1.block1_full, "block1_full"
        else:
            b1, form = B1.block1_packed if mesh is None else B1.make_sharded_block1(mesh), "pair"
        segments = [Segment(b1, ("conv1_1", "conv1_2"), _kept("grams", "conv1_1", style))]
        route = [("block1", form)]

        def pair(label, convs, level, cin, cmid, *, pool, gram, keep=()):
            """A two-conv segment on an activation ``w >> level`` wide."""
            fn, form = _two_convs(w >> level, cin, cmid, pool=pool, gram=gram, mesh=mesh,
                                  block2=label == "block2")
            if gram:
                keep += _kept("grams", convs[0], style)
            segments.append(Segment(fn, convs, keep))
            route.append((label, form))

        def even(k):  # 2**k divides both extents: what enters pool k is even
            return h % (1 << k) == 0 and w % (1 << k) == 0

        covered, seam = {"conv1_1"}, (2, 0)
        tail4 = {"conv4_3", "conv4_4", "pool4"}
        if not full1 and self._clear(2, content, style, layers) and even(2):
            pair("block2", ("conv2_1", "conv2_2"), 1, 64, 128, pool=True, gram=True)
            covered, seam = covered | {"conv2_1"}, (3, 0)
            if self._blocks[3] == 4 and self._clear(3, content, style, layers) and even(3):
                pair("block3_front", ("conv3_1", "conv3_2"), 2, 128, 256, pool=False, gram=True)
                pair("block3_tail", ("conv3_3", "conv3_4"), 2, 256, 256, pool=True, gram=False)
                covered, seam = covered | {"conv3_1"}, (4, 0)
                # conv4_1 exists only as its Gram, conv4_2 as the front's output
                if "conv4_1" not in content and not tail4 & set(layers) and even(4):
                    pair("block4_front", ("conv4_1", "conv4_2"), 3, 256, 512, pool=False,
                         gram=True, keep=_kept("feats", "conv4_2", layers, 0))
                    covered, seam = covered | {"conv4_1", "conv4_2"}, (4, 2)
                    if any(l not in covered for l in layers):
                        pair("block4_tail", ("conv4_3", "conv4_4"), 3, 512, 512, pool=True,
                             gram=False)
                        covered, seam = covered | tail4, (5, 0)
        deeper = tuple(l for l in layers if l not in covered)
        if deeper == ("conv5_1",) and seam == (5, 0) and "conv5_1" not in content:
            impl = dispatch.gram_tail_impl(w >> 4, 512)
            if impl == "conv_gram":
                tail = CG.conv_gram if mesh is None else CG.make_sharded_conv_gram(mesh)
            else:
                tail = CS.gram_tail if mesh is None else CS.make_sharded_gram_tail(mesh)
            segments.append(Segment(tail, ("conv5_1",), ((0, "grams", "conv5_1"),)))
            route.append(("conv5_1", impl))
            deeper = ()
        if not deeper:
            return Plan(tuple(segments), None, tuple(route))
        route.append((f"block{seam[0]}+", "plain" if mesh is None else "plain_sharded"))
        return Plan(tuple(segments), Tail(deeper, *seam), tuple(route))

    def _plain(self, tail: Tail, x, params, remat: bool):
        """The plain forward; per row shard where ``x`` is a mesh's list."""
        extract = vgg.extract_features_sharded if isinstance(x, list) else vgg.extract_features
        return extract(params, x, tail.layers, pooling=self.pooling, arch=self.arch, remat=remat,
                       start_block=tail.start_block, start_conv=tail.start_conv)


def _two_convs(w: int, cin: int, cmid: int, *, pool: bool, gram: bool, mesh, block2: bool):
    """Kernel callable for a two-conv segment whose activation is ``w`` wide,
    per :func:`dispatch.segment_impl`, and its form's name; with a ``mesh``,
    the sharded form."""
    impl = dispatch.segment_impl(w, cin, cmid, pool=pool, gram=gram)
    if impl == "singles":
        return CS.make_pair_of_singles(pool=pool, gram=gram, mesh=mesh), "singles"
    if mesh is not None:
        return CP.make_sharded_pair(mesh, pool=pool, gram=gram), "pair"
    if block2:
        return B2.block2_fused, "pair"
    return (CP.pair_gram if gram else CP.pair_pool), "pair"


#: Pixels from which ``remat=None`` turns remat on for a full ResNet-50
#: plan: where what the forward keeps for the backward and the stem's im2col
#: operand (``models.resnet.peak_bytes_per_pixel``, 463 bytes a pixel) reach
#: the VGG chain's budget of 57220 MiB: 129.6 Mpx (11384 px square).
REMAT_AUTO_PIXELS_RESNET = int(57220 * 2 ** 20 / resnet.peak_bytes_per_pixel())


class ResNet50(_Network):
    """ResNet-50 (module docstring). It takes no mesh and no other pooling
    than its stem's."""

    remat_auto_pixels = REMAT_AUTO_PIXELS_RESNET

    def __init__(self, arch: str, *, pooling: Optional[str] = None,
                 mesh: Optional[M.Mesh] = None):
        if mesh is not None:
            raise ValueError("ResNet-50 does not run on a mesh: its strided convolutions "
                             "have no row-sharded form; use StyleTransfer without mesh=")
        if pooling not in (None, resnet.POOLING):
            raise ValueError(f"ResNet-50 pools with its stem's {resnet.POOLING!r} pool, "
                             f"got pooling={pooling!r}")
        self.arch = arch
        self.pooling = resnet.POOLING

    def plan(self, h: int, w: int, content_layers, style_layers, *, fused: bool,
             fused_block1: bool, config_layers) -> Plan:
        """The kernels under ``fused`` (``fused_block1`` is VGG's), else the
        plain path; the extent does not change the route."""
        layers = _union(content_layers, style_layers)
        if not fused:
            return Plan((), Tail(layers), ((resnet.ARCH, "plain"),))
        stop = resnet.deepest_layer(layers)
        segments = [Segment(RK.stem_pool, ("conv1",), _kept("feats", "conv1", layers))]
        route = [("conv1", "im2col_gemm"), ("maxpool", "kernel")]
        for s in range(1, resnet.LAYER_NAMES.index(stop) + 1):  # stage s makes layer{s}
            name = f"layer{s}"
            segments.append(Segment(functools.partial(RK.stage, s=s), None,
                                    _kept("feats", name, layers, 0)))
            route.append((name, "bottlenecks"))
        return Plan(tuple(segments), None, tuple(route))

    def _plain(self, tail: Tail, x, params, remat: bool):
        return resnet.extract_features(params, x, tail.layers, remat=remat)


#: The network class of each architecture ``models.infer_arch`` names:
#: ``NETWORKS[arch](arch, pooling=..., mesh=...)`` raises for what it cannot
#: run on.
NETWORKS = {**{arch: VGG for arch in vgg.ARCH_BLOCKS}, resnet.ARCH: ResNet50}
