"""Stylization API (PyTorch port): build the model, capture content and style
targets, run the coarse-to-fine optimize loop, emit progress.

Counterpart of ``style_transfer_tpu/api.py`` (``StylizeConfig``,
``StyleTransfer``, ``stylize``, ``_build_objective``, ``_init_image``).
PyTorch runs eagerly, so there is no program cache, no background compile
and no donation: each scale captures its targets, then queues its chunks of
optimizer steps from a Python loop and reads the per-step losses once per
chunk.

The objective keeps the JAX fused-chain dispatch (``api.py:644-918``):
block 1 (``ops/kernels/block1.py``) -> block 2 -> block-3 front/tail
segments -> block-4 front/tail segments -> the conv5_1 Gram tail, plus the
fused TV loss (``epilogue.py``), under the same structural gates (average
pooling, the per-block layer conditions, even extents at every pool
boundary, VGG-19 for blocks 3-4, ``deeper == ("conv5_1",)`` for the Gram
tail) and without the TPU-only ones (backend checks, mesh row gates). Each
two-conv segment takes its form from the reference's size rule
(``ops/kernels/dispatch.py``, JAX ``_seg_fn`` at ``api.py:723-746``): the
fused pair (``block2.py``, ``conv_pair.py``) below effective width 2048,
two singles (``conv_single.py``) from there on; conv5_1 runs
``conv_gram.py`` up to effective width 2048 and ``conv_single.gram_tail``
beyond it (``api.py:860-899``). Two departures from the reference's
dispatch, both in ``dispatch.py``: block 1 stays on its kernel at every
width, and the reference's W-sliced "wide" singles run unsliced. Block 4
engages only when its whole block can chain (the JAX auto mode); the
tail segment runs only when a deeper layer needs it — eager PyTorch has no
dead-code elimination to drop an unused kernel.

Content and style targets are captured through the same chain under
``torch.no_grad()`` (conv4_2 from the block-4 front segment, Grams from the
chain's Gram outputs), so on the GPU the kernels carry all of the main
path's VGG work. The JAX package captures through plain XLA instead
(``api.py:992-999``); on the CPU both sides run plain ops, so they agree.

``StylizeConfig(fused_block1=True)`` is the reference's opt-in objective
(``api.py:480-489``, ``:919-958``) and takes precedence over the chain: block
1 runs as ``block1_full`` (``ops/kernels/block1.py``, one pass from the
image), blocks 2-5 as the plain ``extract_features(start_block=2)``, and the
materialized activations go to ``_gram_fn`` (``ops/kernels/gram.py``, which
sends the channel widths of its ``KERNEL_CHANNELS``, from
``KERNEL_MIN_ELEMENTS`` elements on, to the streaming Gram kernel). Odd extents take the plain path. Content and style targets of that
path are captured through the same functions. The reference engages it only
up to W = 1024 (a limit of its TPU compiler); the port has no width limit
(``ops/kernels/dispatch.py``).

On a CUDA device the compute dtype is bf16 and the chain runs the
hand-written kernels (which take bf16 only: another compute dtype on the
card raises for the chain); on the CPU it is fp32 and the chain runs each
kernel's plain PyTorch version. ``use_fused=False`` runs the plain
``extract_features`` path everywhere (the JAX ``--unfused``).

The optimizer is Adam or L-BFGS (``optim.py``; L-BFGS's zoom line search
evaluates the same objective, kernels and all, at each trial point). The
chunk loop is the reference's (``api.py:1413-1556``): each chunk is queued
on the device as one :class:`_PendingChunk`, and ``_process`` makes the
per-chunk decision in the reference's order: the loss fetch, the
``debug_checks`` sanitizer, the early-stop rule (``stop_tol`` /
``stop_patience``, decided before the callback so the last event of a run
that stops early carries ``done=True``), then the callback, whose event's
``get_state`` is the resumable state of that chunk;
``stylize(resume_state=...)`` continues from it (``utils/ckpt.py``).

Pipelined chunks (``StylizeConfig.pipeline_chunks``, on by default below
:data:`REMAT_AUTO_PIXELS`): the loop queues chunks k+1 and k+2 before it
processes chunk k (:data:`_PIPELINE_DEPTH`), so the card runs on while the
host fetches, checks and reports; an early stop at chunk k drops the
speculative chunks and restores chunk k's image and EMA from its record.
Three things make that hold on the card. A step makes no host sync: the
mean and std of the preprocessing are device tensors made once, and nothing
else in the step reads the device (``chip_smoke.py`` counts the
synchronizing calls with ``torch.cuda.set_sync_debug_mode``). Each fetch
waits for its own chunk only: the losses go to a pinned host buffer by an
asynchronous copy queued behind the chunk's last step, and ``_process``
waits on the chunk's CUDA event; ``get_image`` and ``get_state`` copy on a
side stream that waits on that event, not on the compute stream, where a
``.cpu()`` would wait for the chunks queued after it. And the callback runs
on a worker thread (:class:`_CallbackSink`) while the loop queues the next
chunk: the reference queues a chunk as one program, but an eager chunk is
thousands of launches, and CUDA blocks a launch once 1021 are pending
(measured on the H100, ``chip_smoke.py`` phase pipeline), a few steps of a
2048^2 chunk, so a host busy in a callback would soon let the card run dry.
Pipelined and sequential runs give the same bits: the same kernels run in
the same order on one stream.

``StylizeConfig.remat`` is the reference's gradient rematerialization
(``api.py:153-163, 602-619, 664``): each kernel call of the chain and of
``fused_block1``'s block 1 runs under a non-reentrant
``torch.utils.checkpoint.checkpoint`` (JAX ``jax.checkpoint`` around each
kernel call), and the plain ``extract_features`` calls checkpoint each
block. The backward then recomputes a kernel's forward (the same CUDA
kernel, which gives the same bits launch to launch) instead of keeping its
residuals across the step; only the handoffs between kernels stay live.
``remat=None`` turns it on from a pixel count measured on the H100
(:data:`REMAT_AUTO_PIXELS`, :data:`REMAT_AUTO_PIXELS_FUSED`). Target capture
runs under ``torch.no_grad()`` and takes no checkpoint.

``StyleTransfer(mesh=...)`` is the reference's spatial mesh
(``api.py:345-367``; ``parallel/mesh.py`` says what is sharded and where):
each scale splits the preprocessed image along H into
``mesh.row_bounds`` shards, one per device of the mesh's first
``mesh.shard_count`` devices (reported as ``ProgressEvent.shards``), and
the VGG runs on those shards. The chain keeps its gates and sends each
segment to its sharded form (``make_sharded_block1``,
``make_sharded_pair`` for block 2 and the pairs, ``make_pair_of_singles(
mesh=...)``, ``make_sharded_conv_gram``, ``make_sharded_gram_tail``); what
the chain does not carry runs ``vgg.extract_features_sharded``, the
counterpart of the reference's XLA-partitioned fallback. The content loss
sums each shard's squared error on the home device and divides by the
global count; the content targets are captured through the same mesh, on
the same rows. Grams come home all-reduced; the style loss, TV and the
total are computed there, and the image, the optimizer and the chunk loop
stay there, unchanged. ``fused_block1`` is ignored under a mesh, as in the
reference (``api.py:480-489``), and the auto thresholds of remat and of
pipelining count the pixels of the most loaded device (all of them where
the mesh repeats one card).

Left out (ROADMAP.md): background compiles (``warm_compile``: the port
compiles nothing per scale), grid snapping and the 2^31 TPU resolution
ceiling, and the ``packed_block*`` switches (the chain engages by its
structural gates alone).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from style_transfer_tpu_torch.models import vgg as vgg_mod
from style_transfer_tpu_torch.models.weights import random_fixture
from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import dispatch
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.ops.kernels import gram as KG
from style_transfer_tpu_torch.optim import OptimizerSpec, make_step_fn
from style_transfer_tpu_torch.parallel import mesh as M
from style_transfer_tpu_torch.schedule import _round_even, build_plan
from style_transfer_tpu_torch.utils import imgio
from style_transfer_tpu_torch.utils.ckpt import flatten_opt_state, restore_opt_state
from style_transfer_tpu_torch.utils.progress import Callback, ProgressEvent


@dataclasses.dataclass(frozen=True)
class StylizeConfig:
    """Stylization knobs; the fields and defaults of the JAX ``StylizeConfig``
    that the port implements."""

    size: Union[int, Tuple[int, int]] = 512  # long side, or exact (H, W)
    min_scale: int = 256
    scale_factor: float = 2.0
    iterations: Sequence[int] = (500,)
    chunk_size: int = 50

    content_layers: Sequence[str] = vgg_mod.DEFAULT_CONTENT_LAYERS
    style_layers: Sequence[str] = vgg_mod.DEFAULT_STYLE_LAYERS
    content_layer_weights: Optional[Sequence[float]] = None
    style_layer_weights: Optional[Sequence[float]] = None

    content_weight: float = 1.0
    style_weight: float = 256.0
    tv_weight: float = 2.0
    style_blend_weights: Optional[Sequence[float]] = None
    style_scale: float = 1.0  # style image long side relative to current scale

    optimizer: OptimizerSpec = OptimizerSpec()
    init: str = "content"  # "content" | "random" | "mean"
    seed: int = 0
    # Exponential moving average of the iterates (decay per step) is the
    # returned image when > 0; the raw image keeps optimizing.
    avg_decay: float = 0.0
    # Convergence-matched stopping (config 4, BASELINE.json:10): stop a scale
    # early when the relative chunk-mean loss improvement stays below
    # ``stop_tol`` for ``stop_patience`` consecutive chunks. 0 disables.
    stop_tol: float = 0.0
    stop_patience: int = 2
    # The fused kernel chain (CUDA kernels on the GPU, their plain versions on
    # the CPU); False = the plain extract_features path everywhere.
    use_fused: bool = True
    # Opt-in: block 1 as the one-pass block1_full kernel and blocks 2-5 plain,
    # instead of the chain (needs use_fused, average pooling and no block-1
    # activation requested beyond conv1_1's Gram; else it changes nothing but
    # still switches the chain off, as in the reference).
    fused_block1: bool = False
    # Pipeline device chunks: queue chunks k+1 and k+2 before fetching chunk
    # k's losses, so the card does not wait for the per-chunk host work (the
    # loss fetch, the callbacks). The same bits as the sequential loop: an
    # early stop restores the stopping chunk's state from its record. None =
    # auto: on below REMAT_AUTO_PIXELS, where the records' image-sized
    # buffers (image, Adam's moments, EMA, display image) cost little.
    pipeline_chunks: Optional[bool] = None
    # Sanitizer: verify every fetched loss term is finite and raise with run
    # coordinates otherwise. Host-side only: the steps are unchanged.
    debug_checks: bool = False
    # Gradient rematerialization: recompute each kernel's (and each plain
    # block's) forward inside the backward instead of storing its residuals.
    # None = auto: on from REMAT_AUTO_PIXELS pixels, or from
    # REMAT_AUTO_PIXELS_FUSED where the full kernel chain carries the VGG.
    remat: Optional[bool] = None

    def end_size(self, content_hw: Tuple[int, int]) -> Tuple[int, int]:
        if isinstance(self.size, int):
            return imgio.scale_size(content_hw, self.size)
        h, w = self.size
        return int(h), int(w)


#: Where ``StyleTransfer()`` without a device finds no card.
NO_CUDA_MESSAGE = (
    "StyleTransfer runs on an NVIDIA GPU by default and CUDA is not "
    'available; pass device="cpu" to run on the CPU'
)

# Auto-remat thresholds, from the H100's own peaks (chip_smoke.py, phase
# cli, part remat_fit; NVIDIA H100 80GB HBM3, 700 W): the peak device memory
# of one stored-path scale of configuration 2's flags, measured at 2048^2
# and 4096^2 and fit as linear in pixels, reaches 75% of the card's 80 GB
# (57220 MiB; the rest is left to the caching allocator and the CUDA
# context) at
#   the full kernel chain: 3258.5 and 12220.3 MiB, 712.2 MiB/Mpx + 271.3 MiB
#     -> 79.96 Mpx (8942 px square);
#   the plain path (bf16): 7039.0 and 26984.0 MiB, 1585.1 MiB/Mpx + 390.7 MiB
#     -> 35.85 Mpx (5988 px square).
# (The reference's REMAT_AUTO_PIXELS are a 16 GB TPU's numbers.) Measured at
# 4096^2, remat on the chain lowered the peak by 3% only (12220 -> 11835
# MiB): block 1's backward transients, which remat does not remove, set it.

#: Pixels per image from which ``StylizeConfig.remat=None`` turns remat on
#: where the plain path carries some of the VGG.
REMAT_AUTO_PIXELS = 35_850_000
#: The same where the full kernel chain carries it
#: (:meth:`StyleTransfer._full_chain_dispatches`).
REMAT_AUTO_PIXELS_FUSED = 79_960_000


def _pipeline_auto(cfg: StylizeConfig, pixels: int) -> bool:
    """Whether a scale of ``pixels`` pixels pipelines its chunks (JAX
    ``_pipeline_auto``, ``api.py:258-268``): ``cfg.pipeline_chunks``, or for
    ``None`` below :data:`REMAT_AUTO_PIXELS`, where the records' image-sized
    buffers leave the card's memory headroom alone. Keyed, as in the
    reference, to the plain path's threshold and not the full chain's."""
    if cfg.pipeline_chunks is not None:
        return cfg.pipeline_chunks
    return pixels < REMAT_AUTO_PIXELS


#: Chunks queued beyond the one being processed in the pipelined loop (JAX
#: ``_PIPELINE_DEPTH``, ``api.py:271-277``). Each holds one record's buffers.
_PIPELINE_DEPTH = 2


class _HostEvent:
    """The CPU's stand-in for a chunk's ``torch.cuda.Event``: a CPU op has
    finished when it returns, so the work queued before the event is done
    when it is made; it keeps the host clock's time of that moment."""

    def __init__(self):
        self.seconds = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        """Milliseconds from this event to ``end``."""
        return (end.seconds - self.seconds) * 1e3


@dataclasses.dataclass
class _PendingChunk:
    """A queued optimizer chunk that the loop has not processed yet (JAX
    ``_PendingChunk``, ``api.py:280-298``): its step count, the iterations
    done at its end, its per-step loss terms (``keys``, and ``loss_host``:
    a (terms, steps) host tensor, pinned on the card and filled by an
    asynchronous copy), the clipped display image (``snap``, made only when
    there is a callback), the chunk-end image, EMA and optimizer state, and
    ``event``, which completes after the chunk's last kernel (a
    ``torch.cuda.Event``; :class:`_HostEvent` on the CPU).

    The record holds references where the reference's holds
    ``optimization_barrier`` copies: nothing the loop runs writes a tensor
    in place (the optimizers return new states), so a record keeps its
    chunk's tensors however many chunks run after it."""

    n: int
    done_iters: int
    keys: Tuple[str, ...]
    loss_host: torch.Tensor
    snap: Optional[torch.Tensor]
    image: torch.Tensor
    ema: Optional[torch.Tensor]
    opt_state: object
    event: object


def _fetch_losses(rows) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """Starts a chunk's one host read: the per-step loss terms of ``rows``
    stacked on the device as (terms, steps). On the card the copy into a
    pinned host buffer is queued behind the chunk's steps and returns at
    once; the buffer holds the values once the chunk's event completes. On
    the CPU the stack is the host tensor."""
    keys = tuple(rows[0])
    stacked = torch.stack([torch.stack([r[k] for r in rows]) for k in keys])
    if stacked.device.type != "cuda":
        return keys, stacked
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    return keys, host


def _chunk_event(device: torch.device):
    """A timing event recorded on the current stream of ``device``: it
    completes after everything queued so far (:class:`_HostEvent` on the
    CPU)."""
    if device.type != "cuda":
        return _HostEvent()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _to_host(tensors: List[torch.Tensor], *, event, stream) -> List[np.ndarray]:
    """Numpy copies of ``tensors``, which the chunk that ends in ``event``
    wrote. On the card they are copied on ``stream``, the side copy stream,
    once ``event`` has completed: each copy waits for that chunk only, not
    for the chunks queued after it on the compute stream, and any thread may
    call this (the web monitor's executor does). A ``.cpu()`` there waits
    for the side stream alone, and ``tensors`` holds the sources until it
    returns, so the allocator cannot give their memory to a later chunk while
    they are read. On the CPU the arrays share the tensors' memory, which
    nothing writes in place."""
    if stream is None:
        return [t.detach().numpy() for t in tensors]
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        return [t.detach().cpu().numpy() for t in tensors]


class _CallbackSink:
    """Hands the progress events of one ``stylize`` call to its callback, in
    order. For a sequential scale it calls the callback on the loop's thread
    before the next chunk is queued. For a pipelined scale it calls it on one
    worker thread, so the loop queues the next chunk meanwhile: an eager
    chunk is thousands of launches, and CUDA holds only a bounded
    number pending, so the loop that stops queueing for a callback soon
    leaves the card without work (PERF.md). One event at a time is out:
    handing over the next waits for the previous callback and raises what
    it raised, as :meth:`wait` does."""

    def __init__(self, callback: Callback):
        self.callback = callback
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending = None

    def __call__(self, event: ProgressEvent, *, threaded: bool) -> None:
        self.wait()
        if not threaded:
            self.callback(event)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="stylize-callback")
        self._pending = self._pool.submit(self.callback, event)

    def wait(self) -> None:
        """Returns when the last event handed over has been delivered."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        """Stops the worker thread after the callback it runs, if any."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def _checkpointed(fn):
    """``fn`` under a non-reentrant checkpoint: its forward runs again in the
    backward. The kernels draw no random numbers, so no RNG state is kept."""
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def _style_size(style_hw, scale_hw, style_scale: float) -> Tuple[int, int]:
    """Even-rounded style-image size for a scale."""
    long_side = max(32, int(round(max(scale_hw) * style_scale)))
    sh, sw = imgio.scale_size(style_hw, long_side)
    return sh - sh % 2, sw - sw % 2


def _hw(t) -> Tuple[int, int]:
    """(H, W) of an NHWC tensor, or of the image a list of H shards makes."""
    if isinstance(t, (list, tuple)):
        return sum(M.rows_of(t)), int(t[0].shape[2])
    return int(t.shape[1]), int(t.shape[2])


def _even(t) -> bool:
    h, w = _hw(t)
    return h % 2 == 0 and w % 2 == 0


def _segment(handoff, cin: int, cmid: int, *, pool: bool, gram: bool, block2: bool = False,
             mesh: Optional[M.Mesh] = None):
    """Kernel callable for one two-conv segment fed by ``handoff``, per
    :func:`dispatch.segment_impl` (JAX ``_seg_fn``, ``api.py:723-746``), and
    its name; with a ``mesh``, the sharded form."""
    impl = dispatch.segment_impl(_hw(handoff)[1], cin, cmid, pool=pool, gram=gram)
    if impl == "singles":
        return CS.make_pair_of_singles(pool=pool, gram=gram, mesh=mesh), "singles"
    if mesh is not None:
        return CP.make_sharded_pair(mesh, pool=pool, gram=gram), "pair"
    if block2:
        return B2.block2_fused, "pair"
    return (CP.pair_gram if gram else CP.pair_pool), "pair"


def _mesh_content_loss(home: torch.device):
    """The content loss of sharded activations: each shard's squared error
    summed on its device, the sums added on ``home`` and divided by the
    global element count (the port's ``losses.content_loss`` on the whole
    activation)."""

    def content_loss(feats, targets):
        sse = [torch.sum(torch.square(f.to(torch.float32) - t.to(torch.float32)))
               for f, t in zip(feats, targets)]
        return M.all_reduce_to(sse, home) / float(sum(f.numel() for f in feats))

    return content_loss


def _mesh_gram(gram_fn, home: torch.device):
    """The Gram of sharded activations: ``gram_fn`` of each non-empty shard,
    weighted by its share of the rows and added on ``home``."""

    def gram(feats):
        total = float(sum(f.shape[1] for f in feats))
        return M.all_reduce_to([gram_fn(f) * (f.shape[1] / total) for f in feats if f.shape[1]],
                               home)

    return gram


class StyleTransfer:
    """Model weights on a device, and the stylization loop.

    ``params=None`` uses the port's numpy-drawn VGG-19 fixture
    (:func:`~style_transfer_tpu_torch.models.weights.random_fixture`); pass
    weights from :func:`~style_transfer_tpu_torch.models.weights.load_npz`
    for real stylization. ``device=None`` means the card: without a CUDA
    device it raises, and the CPU is used only when asked with
    ``device="cpu"``. ``compute_dtype`` defaults to bf16 on CUDA and fp32 on
    the CPU (``api.py:362-364``).
    """

    def __init__(self, params=None, *, mean=None, std=None, pooling: str = "average",
                 compute_dtype: Optional[torch.dtype] = None, device=None,
                 mesh: Optional[M.Mesh] = None):
        if params is None:
            params, fmean, fstd = random_fixture(0)
            mean = fmean if mean is None else mean
            std = fstd if std is None else std
        self.mesh = mesh
        if mesh is not None:
            if device is not None and M.canonical_device(device) != mesh.home:
                raise ValueError(f"device={device} is not the mesh's first device {mesh.home}")
            device = mesh.home
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(NO_CUDA_MESSAGE)
            device = "cuda"
        self.device = torch.device(device)
        self.mean = np.asarray(imgio.IMAGENET_MEAN if mean is None else mean, np.float32)
        self.std = np.asarray(imgio.IMAGENET_STD if std is None else std, np.float32)
        # the preprocessing's constants on the device, made once (the JAX
        # package folds them into its programs): an evaluation copies nothing
        # from the host
        self._mean = torch.as_tensor(self.mean).to(self.device)
        self._std = torch.as_tensor(self.std).to(self.device)
        # where get_image / get_state copy a chunk's tensors to the host
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.pooling = pooling
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.arch = vgg_mod.infer_arch(params)
        self.params = {
            name: {k: torch.as_tensor(v, dtype=torch.float32).to(self.device) for k, v in p.items()}
            for name, p in params.items()
        }
        if mesh is not None:
            M.replicate(self.params, mesh)  # one copy per other device, made now
        # the chain's route of the last VGG forward: (segment, form) pairs
        self.last_route: Tuple[Tuple[str, str], ...] = ()

    # ---------------------------------------------------------------- model

    def _scale_mesh(self, h: int):
        """``(mesh, bounds)`` for an image of ``h`` rows: the row bounds of
        ``mesh.row_bounds`` and the mesh of the devices they use; ``(None,
        None)`` without a mesh."""
        if self.mesh is None:
            return None, None
        bounds = M.row_bounds(h, self.mesh.size)
        return self.mesh.take(len(bounds)), bounds

    def _input(self, image: torch.Tensor):
        """The preprocessed image in the compute dtype, scattered along H
        over the scale's mesh where there is one; and that mesh."""
        x = imgio.preprocess(image, self._mean, self._std).to(self.compute_dtype)
        mesh, bounds = self._scale_mesh(image.shape[1])
        return (x if mesh is None else M.scatter_rows(x, bounds, mesh)), mesh

    def _features(self, image: torch.Tensor, layers: Sequence[str],
                  remat: bool = False) -> Dict[str, torch.Tensor]:
        """Preprocess + plain VGG forward on an NHWC [0,1] image; under a
        mesh, per shard (each activation a list of shards)."""
        if self.mesh is not None:
            xs, _ = self._input(image)
            self.last_route = (("vgg", "plain_sharded"),)
            return vgg_mod.extract_features_sharded(
                self.params, xs, layers, pooling=self.pooling, arch=self.arch, remat=remat)
        x = imgio.preprocess(image, self._mean, self._std)
        self.last_route = (("vgg", "plain"),)
        return vgg_mod.extract_features(
            self.params, x, layers, pooling=self.pooling,
            compute_dtype=self.compute_dtype, arch=self.arch, remat=remat,
        )

    def _weights(self, *names):
        out = []
        for name in names:
            out += [self.params[name]["kernel"], self.params[name]["bias"]]
        return out

    def _fused(self, cfg: StylizeConfig) -> bool:
        """Whether the chain runs: ``cfg.use_fused``. Its CUDA kernels take
        bf16 only, so on the card a chain with another compute dtype raises
        here; ``use_fused=False`` is the one plain route."""
        if cfg.use_fused and self.device.type == "cuda" and self.compute_dtype != torch.bfloat16:
            raise ValueError(
                f"the CUDA kernels compute in bf16, got compute_dtype={self.compute_dtype}; "
                "use compute_dtype=torch.bfloat16, or StylizeConfig(use_fused=False) "
                "for the plain path"
            )
        return cfg.use_fused

    def _chain(self, cfg: StylizeConfig) -> bool:
        """Whether the fused chain carries the VGG work: ``use_fused`` without
        ``fused_block1``, which takes precedence (``api.py:494``) off a
        mesh."""
        return self._fused(cfg) and not (cfg.fused_block1 and self.mesh is None)

    def _gram_fn(self, cfg: StylizeConfig):
        """Gram of a materialized activation (``api.py:408-413``); under a
        mesh, of its shards."""
        fn = KG.gram_matrix if cfg.use_fused else L.gram_matrix
        return fn if self.mesh is None else _mesh_gram(fn, self.device)

    def _loss_fns(self, cfg: StylizeConfig) -> dict:
        """Fused-epilogue hooks for :func:`ops.losses.objective_terms`
        (``api.py:415-460``): the TV kernel. The content and style epilogues
        (``ops/kernels/epilogue.py``) stay opt-in hooks of
        ``objective_terms``, as in the reference: in the 1024 px objective
        step on the H100 their gain was at the edge of the run-to-run spread,
        and their effect on the chain's small, host-bound scales was not
        measured (PERF.md)."""
        fns = {"tv_loss_fn": EP.tv_loss} if cfg.use_fused else {}
        if self.mesh is not None:
            fns["content_loss_fn"] = _mesh_content_loss(self.device)
        return fns

    def _block1_eligible(self, cfg: StylizeConfig) -> bool:
        """Whether ``block1_full`` carries block 1 (``api.py:480-489``):
        explicit opt-in, under ``use_fused`` and the structural gate, and
        without a mesh."""
        return (
            cfg.fused_block1
            and self.mesh is None
            and self._fused(cfg)
            and self._block1_structurally_eligible(cfg.content_layers, cfg.style_layers)
        )

    def _block1_structurally_eligible(self, content_layers, style_layers) -> bool:
        """Average pooling, no block-1 activation demanded beyond conv1_1's
        Gram, and at least one deeper layer for pool1 to feed."""
        if self.pooling != "average":
            return False
        b1 = {"conv1_1", "conv1_2", "pool1"}
        if set(content_layers) & b1 or set(style_layers) & (b1 - {"conv1_1"}):
            return False
        return any(l not in b1 for l in list(content_layers) + list(style_layers))

    def _block2_eligible(self, content_layers, style_layers) -> bool:
        if not self._block1_structurally_eligible(content_layers, style_layers):
            return False
        b2 = {"conv2_1", "conv2_2", "pool2"}
        if set(content_layers) & b2 or set(style_layers) & (b2 - {"conv2_1"}):
            return False
        b12 = b2 | {"conv1_1", "conv1_2", "pool1"}
        return any(l not in b12 for l in list(content_layers) + list(style_layers))

    def _block3_eligible(self, content_layers, style_layers) -> bool:
        if not self._block2_eligible(content_layers, style_layers) or self.arch != "vgg19":
            return False
        b3 = {"conv3_1", "conv3_2", "conv3_3", "conv3_4", "pool3"}
        if set(content_layers) & b3 or set(style_layers) & (b3 - {"conv3_1"}):
            return False
        shallow = b3 | {"conv1_1", "conv1_2", "pool1", "conv2_1", "conv2_2", "pool2"}
        return any(l not in shallow for l in list(content_layers) + list(style_layers))

    def _block4_eligible(self, content_layers, style_layers) -> bool:
        """conv4_2's activation is a front-pair output (content or style
        both fine); conv4_1 exists only as its Gram."""
        return (
            self._block3_eligible(content_layers, style_layers)
            and "conv4_1" not in content_layers
        )

    def _full_chain_dispatches(self, h: int, w: int, content_layers, style_layers) -> bool:
        """True when :meth:`_chain_features` on an (h, w) image computes every
        requested layer in kernels and never reaches the plain
        ``extract_features`` (JAX ``_full_chain_dispatches``, ``api.py:208``).
        It mirrors the chain's gates, and picks the auto-remat threshold:
        the kernels store bf16 residuals and masks, the plain path more."""
        all_layers = set(content_layers) | set(style_layers)
        if not (self._block4_eligible(content_layers, style_layers) and h % 16 == 0
                and w % 16 == 0):
            return False  # evenness at the image, pool1, pool2 and pool3
        if all_layers & {"conv4_3", "conv4_4", "pool4"}:
            return False  # the block-4 tail would run plain
        deeper = all_layers - {"conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2"}
        return not deeper or (deeper == {"conv5_1"} and "conv5_1" not in content_layers)

    def _pixels(self, h: int, w: int) -> int:
        """Pixels of an (h, w) image's activations on the most loaded device
        (``api.py:605``: ``H * W // n_dev``; a repeated device holds all of
        its shards)."""
        mesh, bounds = self._scale_mesh(h)
        return h * w if mesh is None else M.pixels_per_device(bounds, w, mesh)

    def _use_remat(self, cfg: StylizeConfig, h: int, w: int) -> bool:
        """``cfg.remat``, or for ``None`` whether an (h, w) image reaches the
        auto threshold of the route ``cfg`` takes (``api.py:602-619``), per
        device under a mesh."""
        if cfg.remat is not None:
            return cfg.remat
        full = (self._chain(cfg)
                and self._full_chain_dispatches(h, w, cfg.content_layers, cfg.style_layers))
        return self._pixels(h, w) >= (REMAT_AUTO_PIXELS_FUSED if full else REMAT_AUTO_PIXELS)

    def _chain_features(self, image, content_layers, style_layers, remat: bool = False):
        """The fused-chain VGG forward of ``api.py:644-918``: returns
        ``(feats, grams)`` — activations for the requested layers the chain
        does not carry, and the chain's Grams for requested style layers.
        ``remat`` runs each kernel call under a checkpoint (``api.py:664``).
        Under a mesh every segment runs its sharded form on the scale's
        shards, the activations in ``feats`` are lists of shards and the
        Grams lie on the home device."""
        all_layers = tuple(dict.fromkeys(list(content_layers) + list(style_layers)))
        style = set(style_layers)
        if not (self._block1_structurally_eligible(content_layers, style_layers) and _even(image)):
            return self._features(image, all_layers, remat), {}
        ck = _checkpointed if remat else (lambda f: f)
        x, mesh = self._input(image)
        sharded = mesh is not None
        route = [("block1", "pair")]
        grams: Dict[str, torch.Tensor] = {}
        b1 = B1.block1_packed if mesh is None else B1.make_sharded_block1(mesh)
        pool1, g = ck(b1)(x, *self._weights("conv1_1", "conv1_2"))
        if "conv1_1" in style:
            grams["conv1_1"] = g
        covered = {"conv1_1"}
        start_block, handoff, start_conv = 2, pool1, 0
        y42 = None
        if self._block2_eligible(content_layers, style_layers) and _even(pool1):
            b2, form = _segment(pool1, 64, 128, pool=True, gram=True, block2=True, mesh=mesh)
            pool2, g = ck(b2)(pool1, *self._weights("conv2_1", "conv2_2"))
            route.append(("block2", form))
            if "conv2_1" in style:
                grams["conv2_1"] = g
            covered.add("conv2_1")
            start_block, handoff = 3, pool2
            if self._block3_eligible(content_layers, style_layers) and _even(pool2):
                b3f, form_f = _segment(pool2, 128, 256, pool=False, gram=True, mesh=mesh)
                b3t, form_t = _segment(pool2, 256, 256, pool=True, gram=False, mesh=mesh)
                y32, g = ck(b3f)(pool2, *self._weights("conv3_1", "conv3_2"))
                pool3 = ck(b3t)(y32, *self._weights("conv3_3", "conv3_4"))
                route += [("block3_front", form_f), ("block3_tail", form_t)]
                if "conv3_1" in style:
                    grams["conv3_1"] = g
                covered.add("conv3_1")
                start_block, handoff = 4, pool3
                b4_tail = {"conv4_3", "conv4_4", "pool4"}
                if (
                    self._block4_eligible(content_layers, style_layers)
                    and not (b4_tail & set(all_layers))
                    and _even(pool3)
                ):
                    b4f, form = _segment(pool3, 256, 512, pool=False, gram=True, mesh=mesh)
                    y42, g = ck(b4f)(pool3, *self._weights("conv4_1", "conv4_2"))
                    route.append(("block4_front", form))
                    if "conv4_1" in style:
                        grams["conv4_1"] = g
                    covered.update(("conv4_1", "conv4_2"))
                    start_block, handoff, start_conv = 4, y42, 2
                    if any(l not in covered for l in all_layers):
                        b4t, form = _segment(pool3, 512, 512, pool=True, gram=False, mesh=mesh)
                        pool4 = ck(b4t)(y42, *self._weights("conv4_3", "conv4_4"))
                        route.append(("block4_tail", form))
                        covered.update(b4_tail)
                        start_block, handoff, start_conv = 5, pool4, 0
        deeper = tuple(l for l in all_layers if l not in covered)
        if deeper == ("conv5_1",) and start_block == 5 and "conv5_1" not in content_layers:
            impl = dispatch.gram_tail_impl(_hw(handoff)[1], 512)
            if impl == "conv_gram":
                tail = CG.conv_gram if mesh is None else CG.make_sharded_conv_gram(mesh)
            else:
                tail = CS.gram_tail if mesh is None else CS.make_sharded_gram_tail(mesh)
            grams["conv5_1"] = ck(tail)(handoff, *self._weights("conv5_1"))
            route.append(("conv5_1", impl))
            deeper = ()
        feats: Dict[str, torch.Tensor] = {}
        if deeper:
            extract = vgg_mod.extract_features_sharded if sharded else vgg_mod.extract_features
            feats = extract(
                self.params, handoff, deeper, pooling=self.pooling, arch=self.arch,
                remat=remat, start_block=start_block, start_conv=start_conv,
            )
            route.append((f"block{start_block}+", "plain_sharded" if sharded else "plain"))
        if y42 is not None and "conv4_2" in all_layers:
            feats["conv4_2"] = y42
        self.last_route = tuple(route)
        return feats, grams

    def _fused_block1_features(self, image, content_layers, style_layers, remat: bool = False):
        """The ``fused_block1`` VGG forward of ``api.py:923-958``:
        ``block1_full`` from the preprocessed image, then the plain deeper
        blocks from pool1. Returns ``(feats, grams)`` like
        :meth:`_chain_features`; odd extents take the plain path."""
        all_layers = tuple(dict.fromkeys(list(content_layers) + list(style_layers)))
        if not _even(image):
            return self._features(image, all_layers, remat), {}
        ck = _checkpointed if remat else (lambda f: f)
        x = imgio.preprocess(image, self._mean, self._std).to(self.compute_dtype)
        pool1, g1 = ck(B1.block1_full)(x, *self._weights("conv1_1", "conv1_2"))
        deeper = tuple(l for l in all_layers if l != "conv1_1")
        feats: Dict[str, torch.Tensor] = {}
        self.last_route = (("block1", "block1_full"),)
        if deeper:
            feats = vgg_mod.extract_features(
                self.params, pool1, deeper, pooling=self.pooling, arch=self.arch,
                remat=remat, start_block=2,
            )
            self.last_route += (("block2+", "plain"),)
        return feats, ({"conv1_1": g1} if "conv1_1" in style_layers else {})

    def _vgg(self, cfg: StylizeConfig, image, content_layers, style_layers, remat: bool = False):
        """``(feats, grams)`` of ``image`` by the route ``cfg`` selects."""
        if self._block1_eligible(cfg):
            return self._fused_block1_features(image, content_layers, style_layers, remat)
        if self._chain(cfg):
            return self._chain_features(image, content_layers, style_layers, remat)
        layers = tuple(dict.fromkeys(list(content_layers) + list(style_layers)))
        return self._features(image, layers, remat), {}

    def _build_objective(self, cfg: StylizeConfig):
        """``objective(image, c_targets, s_targets) -> (loss, terms)`` with
        the dispatch decisions of ``cfg`` baked in."""
        c_weights = L.normalize_layer_weights(cfg.content_layers, cfg.content_layer_weights)
        s_weights = L.normalize_layer_weights(cfg.style_layers, cfg.style_layer_weights)
        self._fused(cfg)  # a chain or fused block 1 on the card needs bf16: raise here
        gram_fn = self._gram_fn(cfg)
        loss_fns = self._loss_fns(cfg)

        def objective(image, c_targets, s_targets):
            remat = self._use_remat(cfg, image.shape[1], image.shape[2])
            feats, grams = self._vgg(cfg, image, cfg.content_layers, cfg.style_layers, remat)
            terms = L.objective_terms(
                feats,
                gram_overrides=grams or None,
                content_targets=c_targets,
                style_targets=s_targets,
                content_layer_weights=c_weights,
                style_layer_weights=s_weights,
                image=image,
                content_weight=cfg.content_weight,
                style_weight=cfg.style_weight,
                tv_weight=cfg.tv_weight,
                gram_fn=gram_fn,
                **loss_fns,
            )
            return terms["loss"], terms

        return objective

    @torch.no_grad()
    def _capture_content(self, cfg: StylizeConfig, image) -> Dict[str, torch.Tensor]:
        feats, _ = self._vgg(cfg, image, cfg.content_layers, ())
        return {l: feats[l] for l in cfg.content_layers}

    @torch.no_grad()
    def _capture_style(self, cfg: StylizeConfig, image) -> Dict[str, torch.Tensor]:
        feats, grams = self._vgg(cfg, image, (), cfg.style_layers)
        gram_fn = self._gram_fn(cfg)
        return {l: grams[l] if l in grams else gram_fn(feats[l]) for l in cfg.style_layers}

    # ------------------------------------------------------------- stylize

    def stylize(
        self,
        content: np.ndarray,
        styles: Union[np.ndarray, Sequence[np.ndarray]],
        config: Optional[StylizeConfig] = None,
        *,
        callback: Optional[Callback] = None,
        init_image: Optional[np.ndarray] = None,
        resume_state: Optional[dict] = None,
        output_dtype: str = "float32",
    ) -> np.ndarray:
        """Run the full multi-scale stylization; returns RGB (H, W, 3), float
        in [0, 1] or, with ``output_dtype="uint8"``, quantized on the device.
        ``content``/``styles`` are RGB (H, W, 3) arrays, float in [0, 1] or
        uint8. ``resume_state`` (a ``ProgressEvent.get_state()`` of this
        package or of the JAX package, or ``CheckpointManager.latest()``)
        skips the scales before its own and restores the image, the EMA and
        the optimizer state."""
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32 or uint8, got {output_dtype!r}")
        cfg = config or StylizeConfig()
        if getattr(styles, "ndim", 0) == 3:
            styles = [styles]
        styles = list(styles)
        if not styles:
            raise ValueError("need at least one style image")
        blend = cfg.style_blend_weights or [1.0] * len(styles)
        if len(blend) != len(styles):
            raise ValueError(f"{len(styles)} styles but {len(blend)} blend weights")

        content_t = imgio.to_nhwc(content, self.device)
        style_ts = [imgio.to_nhwc(s, self.device) for s in styles]
        requested_size = cfg.end_size(tuple(content_t.shape[1:3]))
        plan = build_plan(
            requested_size, cfg.iterations, min_scale=cfg.min_scale, factor=cfg.scale_factor
        )
        delivered = (_round_even(requested_size[0]), _round_even(requested_size[1]))
        explicitly_changed = (
            delivered != tuple(requested_size)
            if not isinstance(cfg.size, int)
            else max(delivered) != max(requested_size)
        )
        if explicitly_changed:
            warnings.warn(
                f"requested output size {tuple(requested_size)} rounded to "
                f"{delivered} (sizes are rounded to even for VGG pooling)",
                stacklevel=2,
            )

        objective = self._build_objective(cfg)
        averaging = cfg.avg_decay > 0
        image = ema = None
        resume_scale = resume_iters = -1
        if resume_state is not None:
            resume_scale = int(resume_state["scale_index"])
            resume_iters = int(resume_state["iteration"])
            if resume_scale >= len(plan):
                raise ValueError(
                    f"checkpoint at scale {resume_scale} but plan has {len(plan)} scales"
                )
        sink = _CallbackSink(callback) if callback is not None else None
        try:
            for scale in plan:
                if scale.index < resume_scale:
                    continue
                h, w = scale.size
                content_s = imgio.resize_image(content_t, (h, w))
                c_targets = self._capture_content(cfg, content_s)
                gram_list: Dict[str, list] = {l: [] for l in cfg.style_layers}
                for st in style_ts:
                    st_s = imgio.resize_image(
                        st, _style_size(st.shape[1:3], (h, w), cfg.style_scale))
                    grams = self._capture_style(cfg, st_s)
                    for l in cfg.style_layers:
                        gram_list[l].append(grams[l])
                s_targets = {l: L.blend_grams(gs, blend) for l, gs in gram_list.items()}

                step, optimizer = make_step_fn(
                    lambda im, c=c_targets, s=s_targets: objective(im, c, s), cfg.optimizer
                )
                if scale.index == resume_scale:
                    image = self._state_image(resume_state["image"])
                    if tuple(image.shape) != (1, h, w, 3):
                        raise ValueError(
                            f"checkpoint image shape {tuple(image.shape)} does not match "
                            f"scale {scale.index} shape (1, {h}, {w}, 3)"
                        )
                    opt_state = restore_opt_state(optimizer.init(image),
                                                  list(resume_state["opt_state_leaves"]))
                    done_iters = min(resume_iters, scale.iterations)
                    if averaging:
                        ema = self._state_image(resume_state.get("ema", resume_state["image"]))
                else:
                    if image is None:
                        image = self._init_image(cfg, content_s, init_image, (h, w))
                        ema = image.clone() if averaging else None
                    else:
                        image = imgio.resize_image(image, (h, w))
                        if averaging:
                            ema = imgio.resize_image(ema, (h, w))
                    # contiguous, as a resumed image is: one layout, the same sums
                    image = image.contiguous()
                    ema = ema.contiguous() if averaging else None
                    opt_state = optimizer.init(image)
                    done_iters = 0

                pipeline = _pipeline_auto(cfg, self._pixels(h, w))
                shards = 1 if self.mesh is None else M.shard_count(h, self.mesh.size)
                prev_mean, stall, t_prev, prev_event = None, 0, 0.0, None

                def _process(rec: _PendingChunk) -> bool:
                    """Fetch a queued chunk's losses, run the sanitizer, the
                    early-stop decision and the callback; True when the scale
                    stops after this chunk."""
                    nonlocal prev_mean, stall, prev_event
                    rec.event.synchronize()  # this chunk's work, not the chunks queued after it
                    fetched = rec.loss_host.numpy()
                    losses = {k: fetched[i] for i, k in enumerate(rec.keys)}
                    # dt: from the previous chunk's end to this one's, on the
                    # card's clock. The reference reads it between its fetches,
                    # which follow the chunks' ends while its host stays ahead;
                    # an eager host blocks on the launch queue instead, and finds
                    # the chunks it drains at a scale's end long done. A chunk
                    # queued when no other was: the host's clock since then.
                    if prev_event is None:
                        dt = time.perf_counter() - t_prev
                    else:
                        dt = prev_event.elapsed_time(rec.event) / 1e3
                    prev_event = rec.event

                    if cfg.debug_checks:
                        bad = {k: v for k, v in losses.items() if not np.isfinite(v).all()}
                        if bad:
                            raise FloatingPointError(
                                f"non-finite loss terms {sorted(bad)} at scale "
                                f"{scale.index} ({h}x{w}), iteration {rec.done_iters}"
                            )

                    # Early stop is decided BEFORE the callback, so the final
                    # event of a run that stops early carries done=True.
                    stop = False
                    if cfg.stop_tol > 0:
                        mean_loss = float(np.mean(losses["loss"]))
                        if prev_mean is not None:
                            rel = abs(prev_mean - mean_loss) / max(abs(prev_mean), 1e-12)
                            stall = stall + 1 if rel < cfg.stop_tol else 0
                            stop = stall >= cfg.stop_patience
                        prev_mean = mean_loss

                    if sink is not None:
                        fetch = functools.partial(_to_host, event=rec.event,
                                                  stream=self._copy_stream)
                        sink(
                            ProgressEvent(
                                scale_index=scale.index,
                                num_scales=len(plan),
                                size=(h, w),
                                iteration=rec.done_iters,
                                total_iterations=scale.iterations,
                                losses=losses,
                                its_per_sec=rec.n / dt if dt > 0 else float("inf"),
                                get_image=lambda s=rec.snap, f=fetch: f([s])[0],
                                done=scale.index == plan[-1].index
                                and (rec.done_iters >= scale.iterations or stop),
                                get_state=functools.partial(
                                    _resumable_state, rec.image, rec.opt_state, rec.done_iters,
                                    scale.index, rec.ema, fetch),
                                shards=shards,
                            ),
                            threaded=pipeline,
                        )
                    return stop

                # Up to _PIPELINE_DEPTH chunks stay queued beyond the one being
                # processed; sequentially each is processed before the next is
                # queued. Nothing the loop runs writes a tensor in place (the
                # optimizers return new states), so each record keeps its own
                # chunk's image, EMA and state however many chunks follow it:
                # the rollback below and get_state rely on that.
                queue: deque = deque()
                depth = _PIPELINE_DEPTH if pipeline else 0
                stopped = False
                while done_iters < scale.iterations:
                    n = min(cfg.chunk_size, scale.iterations - done_iters)
                    if not queue:
                        t_prev, prev_event = time.perf_counter(), None
                    rec = self._dispatch_chunk(step, image, ema, opt_state, n=n,
                                               done_iters=done_iters, decay=cfg.avg_decay,
                                               snapshot=sink is not None)
                    image, ema, opt_state = rec.image, rec.ema, rec.opt_state
                    done_iters = rec.done_iters
                    queue.append(rec)
                    while len(queue) > depth:
                        rec = queue.popleft()
                        if _process(rec):
                            # early stop at this chunk: drop the speculative
                            # chunks queued after it, continue from its state
                            image, ema, done_iters = rec.image, rec.ema, rec.done_iters
                            queue.clear()
                            stopped = True
                            break
                    if stopped:
                        break
                # drain: the scale is complete either way; stop decisions are moot
                while queue:
                    _process(queue.popleft())
                if sink is not None:
                    sink.wait()  # every event of this scale is out before the next scale
        finally:
            if sink is not None:
                sink.close()

        result = ema if averaging else image
        if output_dtype == "uint8":
            return imgio.quantize_u8(result).cpu().numpy()
        return np.clip(result[0].detach().cpu().numpy(), 0.0, 1.0)

    def _dispatch_chunk(self, step, image, ema, opt_state, *, n: int, done_iters: int,
                        decay: float, snapshot: bool) -> _PendingChunk:
        """Queues one chunk: ``n`` optimizer steps with the EMA (``ema`` is
        None without averaging), the clipped display image when
        ``snapshot``, the start of its loss fetch and its event. Nothing here
        reads the device (an L-BFGS step's line search excepted, once per
        line-search step), so on the card this returns once the work is
        queued. Returns the chunk's record."""
        rows = []
        for _ in range(n):
            image, opt_state, aux = step(image, opt_state)
            if ema is not None:
                ema = decay * ema + (1.0 - decay) * image
            rows.append(aux)
        snap = (image if ema is None else ema)[0].clamp(0.0, 1.0) if snapshot else None
        keys, loss_host = _fetch_losses(rows)
        return _PendingChunk(n=n, done_iters=done_iters + n, keys=keys, loss_host=loss_host,
                             snap=snap, image=image, ema=ema, opt_state=opt_state,
                             event=_chunk_event(image.device))

    # ---------------------------------------------------------------- misc

    def _state_image(self, array) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(array, np.float32), device=self.device)

    def _init_image(self, cfg, content_s, init_image, size):
        """``init="random"`` draws from a ``torch.Generator`` seeded with
        ``cfg.seed``: the same seed gives the same image run to run, but not
        the JAX package's ``jax.random.uniform`` draw (``api.py:1585``)."""
        h, w = size
        if init_image is not None:
            return imgio.resize_image(imgio.to_nhwc(init_image, self.device), (h, w))
        if cfg.init == "content":
            return content_s
        if cfg.init == "random":
            gen = torch.Generator().manual_seed(cfg.seed)
            return torch.rand((1, h, w, 3), generator=gen, dtype=torch.float32).to(self.device)
        if cfg.init == "mean":
            return torch.full((1, h, w, 3), 0.5, dtype=torch.float32, device=self.device)
        raise ValueError(f"unknown init mode {cfg.init!r}")


def _resumable_state(image, opt_state, iteration, scale_index, ema, fetch) -> dict:
    """``ProgressEvent.get_state()``: the chunk's state as numpy arrays,
    copied by ``fetch`` (:func:`_to_host` bound to the chunk's event)."""
    state = {
        "image": fetch([image])[0],
        "opt_state_leaves": flatten_opt_state(opt_state, fetch),
        "scale_index": np.asarray(scale_index),
        "iteration": np.asarray(iteration),
    }
    if ema is not None:
        state["ema"] = fetch([ema])[0]
    return state
