"""Stylization API (PyTorch port): build the model, capture content and style
targets, run the coarse-to-fine optimize loop, emit progress.

Counterpart of ``style_transfer_tpu/api.py`` (``StylizeConfig``,
``StyleTransfer``, ``stylize``, ``_build_objective``, ``_init_image``).
PyTorch runs eagerly, so there is no program cache, no background compile
and no donation: each scale captures its targets, then queues its chunks of
optimizer steps from a Python loop and reads the per-step losses once per
chunk.

The network's forward is ``networks.py``'s: ``StyleTransfer`` picks the
architecture's network once (VGG-19 or VGG-16: the fused kernel chain of the
JAX ``api.py:644-918`` with its structural gates and size rule; ResNet-50:
its kernels stage by stage) and asks it for a plan of each forward, which
the objective makes once per image extent. The objective adds the fused TV
loss (``epilogue.py``) and the Grams of the activations the plan leaves
materialized (``_gram_fn``: ``ops/kernels/gram.py``, which sends the channel
widths of its ``KERNEL_CHANNELS``, from ``KERNEL_MIN_ELEMENTS`` elements on,
to the streaming Gram kernel).

Content and style targets are captured through the same network under
``torch.no_grad()`` (conv4_2 from the block-4 front segment, Grams from the
chain's Gram outputs), so on the GPU the kernels carry all of the main
path's network work. The JAX package captures through plain XLA instead
(``api.py:992-999``); on the CPU both sides run plain ops, so they agree.

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
(:data:`REMAT_AUTO_PIXELS`, or the network's ``remat_auto_pixels`` where its
kernels carry every requested layer). Target capture
runs under ``torch.no_grad()`` and takes no checkpoint.

``StyleTransfer(mesh=...)`` is the reference's spatial mesh
(``api.py:345-367``, ``:1375-1403``; ``parallel/mesh.py`` says what is
sharded and where): each scale cuts the image along H into
``mesh.row_bounds`` shards, one per device of the mesh's first
``mesh.shard_count`` devices (reported as ``ProgressEvent.shards``), and
the image stays so through the scale, as the reference's ``shard_image``
places it: the optimizer state (``optim.py``), the EMA, the display image
and each pipelined record hold shards of the same rows on the same
devices. The objective preprocesses each shard on its device, the chain
runs each segment's sharded form and ``vgg.extract_features_sharded`` for
what it does not carry (the counterpart of the reference's XLA-partitioned
fallback; ``networks.py``), and TV runs
``EP.make_sharded_tv_loss`` (the reference's ``make_sharded_tv_loss``, also
on the plain route, with the plain per-shard sums). The content loss sums
each shard's squared error on the home device and divides by the global
count; the content targets are captured through the same mesh, on the same
rows. Grams come home all-reduced; the style loss and the total are
computed there. A whole image given to the objective (a capture, a test)
is cut first, differentiably. The image comes whole to the home device
only between scales, for the resize (``parallel/mesh.py`` counts those
transients); ``get_image``, ``get_state`` and the result gather the shards
by rows on the host, so a checkpoint has the unsharded shapes and resumes
with or without a mesh. ``fused_block1`` is ignored under a mesh, as in
the reference (``api.py:480-489``), and the auto thresholds of remat and of
pipelining count the pixels of the most loaded device (all of them where
the mesh repeats one card).

Spans (``trace.py``; recorded under a profiler or ``trace.recording()``):
``stylize`` is the call, ``scale`` one scale of the plan, inside it
``capture`` (the images resized, the targets captured and blended),
``resize`` (the optimized image and the EMA carried to the scale, or
initialized or restored, and sharded), ``dispatch`` (the body of
``_dispatch_chunk``) and ``process`` (``_process``), inside which ``fetch``
waits on the chunk's event and reads its losses and ``callback`` hands its
event to the sink; ``output`` is the final quantize and copy to the host.

ResNet-50 weights (``models/resnet.py``: the architecture follows from
the parameter keys) take their network's route (``networks.py``); the loss
terms, the optimizers, the loop and its pipelining are the ones VGG uses.
ResNet-50 takes no mesh and no other pooling than its own.

Left out (ROADMAP.md): background compiles (``warm_compile``: the port
compiles nothing per scale), grid snapping and the 2^31 TPU resolution
ceiling, and the ``packed_block*`` switches (the chain engages by its
structural gates alone).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from style_transfer_tpu_torch import trace
from style_transfer_tpu_torch import models
from style_transfer_tpu_torch import networks
from style_transfer_tpu_torch.models import vgg as vgg_mod
from style_transfer_tpu_torch.models.weights import random_fixture
from style_transfer_tpu_torch.ops import losses as L
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
    # None = auto: on from REMAT_AUTO_PIXELS pixels, or from the network's
    # remat_auto_pixels where its kernels carry every requested layer.
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

# The plain path's auto-remat threshold, from the H100's own peaks
# (chip_smoke.py, phase cli, part remat_fit; NVIDIA H100 80GB HBM3, 700 W):
# the peak device memory of one stored-path scale of configuration 2's flags
# on the plain path (bf16), measured at 2048^2 and 4096^2 (7039.0 and 26984.0
# MiB) and fit as linear in pixels (1585.1 MiB/Mpx + 390.7 MiB), reaches 75%
# of the card's 80 GB (57220 MiB; the rest is left to the caching allocator
# and the CUDA context) at 35.85 Mpx (5988 px square). A plan the kernels
# carry whole has its network's own threshold (``remat_auto_pixels`` in
# ``networks.py``). (The reference's REMAT_AUTO_PIXELS are a 16 GB TPU's
# numbers.)

#: Pixels per image from which ``StylizeConfig.remat=None`` turns remat on
#: where the plain path carries some of the network.
REMAT_AUTO_PIXELS = 35_850_000


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
    chunk's tensors however many chunks run after it. On a mesh each of
    its image-sized tensors is a tuple of row shards."""

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
    wrote; a tuple of row shards (a mesh's image-sized tensor) comes back as
    one array, its shards copied by rows into one host buffer
    (:func:`_rows_to_host`). On the card they are copied on ``stream``, the
    side copy stream, once ``event`` has completed: each copy waits for that
    chunk only, not for the chunks queued after it on the compute stream,
    and any thread may call this (the web monitor's executor does). A
    ``.cpu()`` there waits for the side stream alone, and ``tensors`` holds
    the sources until it returns, so the allocator cannot give their memory
    to a later chunk while they are read. On the CPU the arrays share the
    tensors' memory, which nothing writes in place."""
    if stream is None:
        return [_rows_to_host(t, None) if isinstance(t, tuple) else t.detach().numpy()
                for t in tensors]
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        return [_rows_to_host(t, stream) if isinstance(t, tuple) else t.detach().cpu().numpy()
                for t in tensors]


def _rows_to_host(shards: Tuple[torch.Tensor, ...], stream) -> np.ndarray:
    """The row shards of one tensor as one host array: on the card, each
    shard copied into its rows of one pinned buffer (asynchronously on
    ``stream`` for the shards of its device, which the caller made current;
    a shard of another device blocks on that device's stream), then
    ``stream`` synchronized; on the CPU (``stream`` None), the shards
    concatenated."""
    ax = M.row_axis(shards[0])
    if stream is None:
        return torch.cat([s.detach() for s in shards], dim=ax).numpy()
    shape = list(shards[0].shape)
    shape[ax] = sum(int(s.shape[ax]) for s in shards)
    buf = torch.empty(shape, dtype=shards[0].dtype, pin_memory=True)
    lo = 0
    for s in shards:
        n = int(s.shape[ax])
        buf.narrow(ax, lo, n).copy_(s.detach(), non_blocking=s.device == stream.device)
        lo += n
    stream.synchronize()
    return buf.numpy()


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


@contextlib.contextmanager
def _callback_sink(callback: Optional[Callback]):
    """A :class:`_CallbackSink` of ``callback`` (None without one), closed
    on the way out."""
    sink = _CallbackSink(callback) if callback is not None else None
    try:
        yield sink
    finally:
        if sink is not None:
            sink.close()


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
    for real stylization, or ResNet-50's (``models/resnet.py``, batch norm
    folded by ``resnet.fold_batch_norm``): the architecture follows from the
    keys (``models.infer_arch``). ``pooling=None`` is the architecture's
    own: average for VGG, max for ResNet-50 (its stem's, the only one it
    takes). ``device=None`` means the card: without a CUDA device it raises,
    and the CPU is used only when asked with ``device="cpu"``.
    ``compute_dtype`` defaults to bf16 on CUDA and fp32 on the CPU
    (``api.py:362-364``). ResNet-50 does not run on a ``mesh``.
    """

    def __init__(self, params=None, *, mean=None, std=None, pooling: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None, device=None,
                 mesh: Optional[M.Mesh] = None):
        if params is None:
            params, fmean, fstd = random_fixture(0)
            mean = fmean if mean is None else mean
            std = fstd if std is None else std
        self.arch = models.infer_arch(params)
        # the architecture's forward, which checks pooling and mesh
        self.net = networks.NETWORKS[self.arch](self.arch, pooling=pooling, mesh=mesh)
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
        self.pooling = self.net.pooling
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.params = {
            name: {k: torch.as_tensor(v, dtype=torch.float32).to(self.device) for k, v in p.items()}
            for name, p in params.items()
        }
        if mesh is not None:
            M.replicate(self.params, mesh)  # one copy per other device, made now
        # the route of the last forward: (segment, form) pairs
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

    def _shards(self, image) -> List[torch.Tensor]:
        """An image on the mesh as the list of its row shards: a tuple or
        list of shards as it is, a whole image cut at the scale's
        ``row_bounds`` by :func:`parallel.mesh.scatter_rows`
        (differentiable: the gradient comes back whole)."""
        if isinstance(image, (tuple, list)):
            return list(image)
        mesh, bounds = self._scale_mesh(image.shape[1])
        return M.scatter_rows(image, bounds, mesh)

    def _input(self, image):
        """The preprocessed image in the compute dtype. On a mesh, the list
        of its row shards, each preprocessed on its own device; a whole image
        is cut first (:meth:`_shards`)."""
        if self.mesh is None:
            return imgio.preprocess(image, self._mean, self._std).to(self.compute_dtype)
        return [imgio.preprocess(x, *M.replicas(x.device, self._mean, self._std))
                .to(self.compute_dtype) for x in self._shards(image)]

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

    def _gram_fn(self, cfg: StylizeConfig):
        """Gram of a materialized activation (``api.py:408-413``); under a
        mesh, of its shards."""
        fn = KG.gram_matrix if cfg.use_fused else L.gram_matrix
        return fn if self.mesh is None else _mesh_gram(fn, self.device)

    def _loss_fns(self, cfg: StylizeConfig) -> dict:
        """Fused-epilogue hooks for :func:`ops.losses.objective_terms`
        (``api.py:415-460``): the TV kernel; on a mesh the sharded TV (on
        the plain route too, with plain per-shard sums) and the content
        loss of sharded activations. The content and style epilogues
        (``ops/kernels/epilogue.py``) stay opt-in hooks of
        ``objective_terms``, as in the reference: in the 1024 px objective
        step on the H100 their gain was at the edge of the run-to-run spread,
        and their effect on the chain's small, host-bound scales was not
        measured (PERF.md)."""
        if self.mesh is not None:
            return {"tv_loss_fn": EP.make_sharded_tv_loss(self.mesh, fused=cfg.use_fused),
                    "content_loss_fn": _mesh_content_loss(self.device)}
        return {"tv_loss_fn": EP.tv_loss} if cfg.use_fused else {}

    def _pixels(self, h: int, w: int) -> int:
        """Pixels of an (h, w) image's activations on the most loaded device
        (``api.py:605``: ``H * W // n_dev``; a repeated device holds all of
        its shards)."""
        mesh, bounds = self._scale_mesh(h)
        return h * w if mesh is None else M.pixels_per_device(bounds, w, mesh)

    def _plan(self, cfg: StylizeConfig, hw: Tuple[int, int], content_layers, style_layers):
        """The network's plan of a forward of an image of extent ``hw``
        computing ``content_layers`` and ``style_layers`` under ``cfg``
        (``networks.py``)."""
        return self.net.plan(*hw, content_layers, style_layers, fused=self._fused(cfg),
                             fused_block1=cfg.fused_block1,
                             config_layers=(cfg.content_layers, cfg.style_layers))

    def _use_remat(self, cfg: StylizeConfig, plan, h: int, w: int) -> bool:
        """``cfg.remat``, or for ``None`` whether an (h, w) image reaches the
        auto threshold of ``plan`` (``api.py:602-619``): the network's
        ``remat_auto_pixels`` for a full plan, :data:`REMAT_AUTO_PIXELS`
        where the plain path carries some of the work; per device under a
        mesh."""
        if cfg.remat is not None:
            return cfg.remat
        return self._pixels(h, w) >= (self.net.remat_auto_pixels if plan.full
                                      else REMAT_AUTO_PIXELS)

    def _forward(self, plan, image, remat: bool = False):
        """``(feats, grams)`` of ``image`` by ``plan``, preprocessed by
        :meth:`_input`: the requested activations the kernels do not fold
        into a Gram (lists of shards on a mesh), and the kernels' Grams on
        the home device. Sets :attr:`last_route`."""
        feats, grams = self.net.run(plan, self._input(image), self.params, remat)
        self.last_route = plan.route
        return feats, grams

    def _build_objective(self, cfg: StylizeConfig):
        """``objective(image, c_targets, s_targets) -> (loss, terms)`` with
        the dispatch decisions of ``cfg`` baked in: each image extent is
        planned once, at its first evaluation."""
        c_weights = L.normalize_layer_weights(cfg.content_layers, cfg.content_layer_weights)
        s_weights = L.normalize_layer_weights(cfg.style_layers, cfg.style_layer_weights)
        self._fused(cfg)  # a chain or fused block 1 on the card needs bf16: raise here
        gram_fn = self._gram_fn(cfg)
        loss_fns = self._loss_fns(cfg)

        # (h, w) -> (plan, remat): a scale's routes, decided at its first evaluation
        plans: Dict[Tuple[int, int], tuple] = {}

        def objective(image, c_targets, s_targets):
            if self.mesh is not None:  # the network and TV take the row shards
                image = self._shards(image)
            hw = _hw(image)
            if hw not in plans:
                plan = self._plan(cfg, hw, cfg.content_layers, cfg.style_layers)
                plans[hw] = plan, self._use_remat(cfg, plan, *hw)
            plan, remat = plans[hw]
            feats, grams = self._forward(plan, image, remat)
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
        feats, _ = self._forward(self._plan(cfg, _hw(image), cfg.content_layers, ()), image)
        return {l: feats[l] for l in cfg.content_layers}

    @torch.no_grad()
    def _capture_style(self, cfg: StylizeConfig, image) -> Dict[str, torch.Tensor]:
        feats, grams = self._forward(self._plan(cfg, _hw(image), (), cfg.style_layers), image)
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
        with (trace.call(sizes=[scale.size for scale in plan]),
              _callback_sink(callback) as sink):
            for scale in plan:
                if scale.index < resume_scale:
                    continue
                with trace.span("scale", index=scale.index, size=scale.size,
                                iterations=scale.iterations):
                    h, w = scale.size
                    with trace.span("capture"):
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
                    with trace.span("resize"):
                        if scale.index == resume_scale:
                            shape = np.shape(resume_state["image"])
                            if tuple(shape) != (1, h, w, 3):
                                raise ValueError(
                                    f"checkpoint image shape {tuple(shape)} does not match "
                                    f"scale {scale.index} shape (1, {h}, {w}, 3)"
                                )
                            image = self._state_image(resume_state["image"])
                            opt_state = restore_opt_state(optimizer.init(image),
                                                          list(resume_state["opt_state_leaves"]))
                            done_iters = min(resume_iters, scale.iterations)
                            if averaging:
                                ema = self._state_image(
                                    resume_state.get("ema", resume_state["image"]))
                        else:
                            if image is None:
                                image = self._init_image(cfg, content_s, init_image, (h, w))
                                ema = image.clone() if averaging else None
                            else:
                                image = self._resized(image, (h, w))
                                if averaging:
                                    ema = self._resized(ema, (h, w))
                            # contiguous, as a resumed image is: one layout, the same
                            # sums; on a mesh, the row shards (every copy above is freed)
                            image = M.shard_image(image.contiguous(), self.mesh)
                            ema = M.shard_image(ema.contiguous(), self.mesh) if averaging else None
                            opt_state = optimizer.init(image)
                            done_iters = 0
                    del content_s  # captured, and the image's start: not kept for the scale

                    pipeline = _pipeline_auto(cfg, self._pixels(h, w))
                    shards = 1 if self.mesh is None else M.shard_count(h, self.mesh.size)
                    prev_mean, stall, t_prev, prev_event = None, 0, 0.0, None

                    def _process(rec: _PendingChunk) -> bool:
                        """Fetch a queued chunk's losses, run the sanitizer, the
                        early-stop decision and the callback; True when the scale
                        stops after this chunk."""
                        nonlocal prev_mean, stall, prev_event
                        with trace.span("process"):
                            with trace.span("fetch"):
                                # this chunk's work, not the chunks queued after it
                                rec.event.synchronize()
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
                                event = ProgressEvent(
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
                                        _resumable_state, rec.image, rec.opt_state,
                                        rec.done_iters, scale.index, rec.ema, fetch),
                                    shards=shards,
                                )
                                with trace.span("callback"):
                                    sink(event, threaded=pipeline)
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

            with trace.span("output"):
                result = ema if averaging else image
                if isinstance(result, tuple):  # the row shards: each quantized or copied on its own
                    if output_dtype == "uint8":
                        return np.concatenate([imgio.quantize_u8(r).cpu().numpy() for r in result])
                    return np.clip(M.gather_rows(result, "cpu")[0].detach().numpy(), 0.0, 1.0)
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
        queued. Returns the chunk's record. The ``dispatch`` span is the
        body's, so a wrapper of this method runs before it opens."""
        with trace.span("dispatch", steps=n):
            sharded = isinstance(image, tuple)
            rows = []
            for _ in range(n):
                image, opt_state, aux = step(image, opt_state)
                if ema is not None and sharded:  # per shard, one launch per op and device
                    ema = tuple(torch._foreach_add(torch._foreach_mul(ema, decay),
                                                   torch._foreach_mul(image, 1.0 - decay)))
                elif ema is not None:
                    ema = decay * ema + (1.0 - decay) * image
                rows.append(aux)
            snap = None
            if snapshot:
                src = image if ema is None else ema
                snap = (tuple(torch._foreach_clamp_max(torch._foreach_clamp_min(
                            [s[0] for s in src], 0.0), 1.0)) if sharded
                        else src[0].clamp(0.0, 1.0))
            keys, loss_host = _fetch_losses(rows)
            return _PendingChunk(n=n, done_iters=done_iters + n, keys=keys, loss_host=loss_host,
                                 snap=snap, image=image, ema=ema, opt_state=opt_state,
                                 event=_chunk_event(self.device))

    # ---------------------------------------------------------------- misc

    def _state_image(self, array):
        """A checkpoint's image on the device; on a mesh, its row shards, each
        copied from the host to its own device."""
        array = np.ascontiguousarray(array, np.float32)
        if self.mesh is not None:
            return M.shard_image(array, self.mesh)
        return torch.tensor(array, device=self.device)

    def _resized(self, image, size) -> torch.Tensor:
        """The between-scale resize; on a mesh the shards are gathered on
        the home device first (a transient of the old scale's size)."""
        if isinstance(image, tuple):
            image = M.gather_rows(image, self.device)
        return imgio.resize_image(image, size)

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
