"""Stylization API (PyTorch port): build the model, capture content and style
targets, run the coarse-to-fine optimize loop, emit progress.

Counterpart of ``style_transfer_tpu/api.py`` (``StylizeConfig``,
``StyleTransfer``, ``stylize``, ``_build_objective``, ``_init_image``).
PyTorch runs eagerly, so there is no program cache, no background compile
and no donation: each scale captures its targets, then runs its chunks of
optimizer steps in a Python loop and reads the per-step losses once per
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
chunk loop carries the reference's per-chunk decision (``api.py:1433-1498``)
in its order: the ``debug_checks`` sanitizer, the early-stop rule
(``stop_tol`` / ``stop_patience``, decided before the callback so the last
event of a run that stops early carries ``done=True``), then the callback,
whose event's ``get_state`` is the resumable state of that chunk;
``stylize(resume_state=...)`` continues from it (``utils/ckpt.py``).

Left out (ROADMAP.md): pipelined chunks and background compiles, remat,
grid snapping and the 2^31 TPU resolution ceiling, meshes, and the
``packed_block*`` switches (the chain engages by its structural gates alone).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
    # Sanitizer: verify every fetched loss term is finite and raise with run
    # coordinates otherwise. Host-side only: the steps are unchanged.
    debug_checks: bool = False

    def end_size(self, content_hw: Tuple[int, int]) -> Tuple[int, int]:
        if isinstance(self.size, int):
            return imgio.scale_size(content_hw, self.size)
        h, w = self.size
        return int(h), int(w)


def _style_size(style_hw, scale_hw, style_scale: float) -> Tuple[int, int]:
    """Even-rounded style-image size for a scale."""
    long_side = max(32, int(round(max(scale_hw) * style_scale)))
    sh, sw = imgio.scale_size(style_hw, long_side)
    return sh - sh % 2, sw - sw % 2


def _even(t: torch.Tensor) -> bool:
    return t.shape[1] % 2 == 0 and t.shape[2] % 2 == 0


def _segment(handoff: torch.Tensor, cin: int, cmid: int, *, pool: bool, gram: bool,
             block2: bool = False):
    """Kernel callable for one two-conv segment fed by ``handoff``, per
    :func:`dispatch.segment_impl` (JAX ``_seg_fn``, ``api.py:723-746``)."""
    impl = dispatch.segment_impl(handoff.shape[2], cin, cmid, pool=pool, gram=gram)
    if impl == "singles":
        return CS.make_pair_of_singles(pool=pool, gram=gram)
    if block2:
        return B2.block2_fused
    return CP.pair_gram if gram else CP.pair_pool


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
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        if params is None:
            params, fmean, fstd = random_fixture(0)
            mean = fmean if mean is None else mean
            std = fstd if std is None else std
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StyleTransfer runs on an NVIDIA GPU by default and CUDA is not "
                    'available; pass device="cpu" to run on the CPU'
                )
            device = "cuda"
        self.device = torch.device(device)
        self.mean = np.asarray(imgio.IMAGENET_MEAN if mean is None else mean, np.float32)
        self.std = np.asarray(imgio.IMAGENET_STD if std is None else std, np.float32)
        self.pooling = pooling
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.arch = vgg_mod.infer_arch(params)
        self.params = {
            name: {k: torch.as_tensor(v, dtype=torch.float32).to(self.device) for k, v in p.items()}
            for name, p in params.items()
        }

    # ---------------------------------------------------------------- model

    def _features(self, image: torch.Tensor, layers: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Preprocess + plain VGG forward on an NHWC [0,1] image."""
        x = imgio.preprocess(image, self.mean, self.std)
        return vgg_mod.extract_features(
            self.params, x, layers, pooling=self.pooling,
            compute_dtype=self.compute_dtype, arch=self.arch,
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
        ``fused_block1``, which takes precedence (``api.py:494``)."""
        return self._fused(cfg) and not cfg.fused_block1

    def _gram_fn(self, cfg: StylizeConfig):
        """Gram of a materialized activation (``api.py:408-413``)."""
        return KG.gram_matrix if cfg.use_fused else L.gram_matrix

    def _loss_fns(self, cfg: StylizeConfig) -> dict:
        """Fused-epilogue hooks for :func:`ops.losses.objective_terms`
        (``api.py:415-460``): the TV kernel. The content and style epilogues
        (``ops/kernels/epilogue.py``) stay opt-in hooks of
        ``objective_terms``, as in the reference: in the 1024 px objective
        step on the H100 their gain was at the edge of the run-to-run spread,
        and their effect on the chain's small, host-bound scales was not
        measured (PERF.md)."""
        return {"tv_loss_fn": EP.tv_loss} if cfg.use_fused else {}

    def _block1_eligible(self, cfg: StylizeConfig) -> bool:
        """Whether ``block1_full`` carries block 1 (``api.py:480-489``):
        explicit opt-in, under ``use_fused`` and the structural gate."""
        return (
            cfg.fused_block1
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

    def _chain_features(self, image, content_layers, style_layers):
        """The fused-chain VGG forward of ``api.py:644-918``: returns
        ``(feats, grams)`` — activations for the requested layers the chain
        does not carry, and the chain's Grams for requested style layers."""
        all_layers = tuple(dict.fromkeys(list(content_layers) + list(style_layers)))
        style = set(style_layers)
        if not (self._block1_structurally_eligible(content_layers, style_layers) and _even(image)):
            return self._features(image, all_layers), {}
        x = imgio.preprocess(image, self.mean, self.std).to(self.compute_dtype)
        grams: Dict[str, torch.Tensor] = {}
        pool1, g = B1.block1_packed(x, *self._weights("conv1_1", "conv1_2"))
        if "conv1_1" in style:
            grams["conv1_1"] = g
        covered = {"conv1_1"}
        start_block, handoff, start_conv = 2, pool1, 0
        y42 = None
        if self._block2_eligible(content_layers, style_layers) and _even(pool1):
            b2 = _segment(pool1, 64, 128, pool=True, gram=True, block2=True)
            pool2, g = b2(pool1, *self._weights("conv2_1", "conv2_2"))
            if "conv2_1" in style:
                grams["conv2_1"] = g
            covered.add("conv2_1")
            start_block, handoff = 3, pool2
            if self._block3_eligible(content_layers, style_layers) and _even(pool2):
                b3f = _segment(pool2, 128, 256, pool=False, gram=True)
                b3t = _segment(pool2, 256, 256, pool=True, gram=False)
                y32, g = b3f(pool2, *self._weights("conv3_1", "conv3_2"))
                pool3 = b3t(y32, *self._weights("conv3_3", "conv3_4"))
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
                    b4f = _segment(pool3, 256, 512, pool=False, gram=True)
                    y42, g = b4f(pool3, *self._weights("conv4_1", "conv4_2"))
                    if "conv4_1" in style:
                        grams["conv4_1"] = g
                    covered.update(("conv4_1", "conv4_2"))
                    start_block, handoff, start_conv = 4, y42, 2
                    if any(l not in covered for l in all_layers):
                        b4t = _segment(pool3, 512, 512, pool=True, gram=False)
                        pool4 = b4t(y42, *self._weights("conv4_3", "conv4_4"))
                        covered.update(b4_tail)
                        start_block, handoff, start_conv = 5, pool4, 0
        deeper = tuple(l for l in all_layers if l not in covered)
        if deeper == ("conv5_1",) and start_block == 5 and "conv5_1" not in content_layers:
            tail = (CG.conv_gram if dispatch.gram_tail_impl(handoff.shape[2], 512) == "conv_gram"
                    else CS.gram_tail)
            grams["conv5_1"] = tail(handoff, *self._weights("conv5_1"))
            deeper = ()
        feats: Dict[str, torch.Tensor] = {}
        if deeper:
            feats = vgg_mod.extract_features(
                self.params, handoff, deeper, pooling=self.pooling, arch=self.arch,
                start_block=start_block, start_conv=start_conv,
            )
        if y42 is not None and "conv4_2" in all_layers:
            feats["conv4_2"] = y42
        return feats, grams

    def _fused_block1_features(self, image, content_layers, style_layers):
        """The ``fused_block1`` VGG forward of ``api.py:923-958``:
        ``block1_full`` from the preprocessed image, then the plain deeper
        blocks from pool1. Returns ``(feats, grams)`` like
        :meth:`_chain_features`; odd extents take the plain path."""
        all_layers = tuple(dict.fromkeys(list(content_layers) + list(style_layers)))
        if not _even(image):
            return self._features(image, all_layers), {}
        x = imgio.preprocess(image, self.mean, self.std).to(self.compute_dtype)
        pool1, g1 = B1.block1_full(x, *self._weights("conv1_1", "conv1_2"))
        deeper = tuple(l for l in all_layers if l != "conv1_1")
        feats: Dict[str, torch.Tensor] = {}
        if deeper:
            feats = vgg_mod.extract_features(
                self.params, pool1, deeper, pooling=self.pooling, arch=self.arch, start_block=2,
            )
        return feats, ({"conv1_1": g1} if "conv1_1" in style_layers else {})

    def _vgg(self, cfg: StylizeConfig, image, content_layers, style_layers):
        """``(feats, grams)`` of ``image`` by the route ``cfg`` selects."""
        if self._block1_eligible(cfg):
            return self._fused_block1_features(image, content_layers, style_layers)
        if self._chain(cfg):
            return self._chain_features(image, content_layers, style_layers)
        layers = tuple(dict.fromkeys(list(content_layers) + list(style_layers)))
        return self._features(image, layers), {}

    def _build_objective(self, cfg: StylizeConfig):
        """``objective(image, c_targets, s_targets) -> (loss, terms)`` with
        the dispatch decisions of ``cfg`` baked in."""
        c_weights = L.normalize_layer_weights(cfg.content_layers, cfg.content_layer_weights)
        s_weights = L.normalize_layer_weights(cfg.style_layers, cfg.style_layer_weights)
        self._fused(cfg)  # a chain or fused block 1 on the card needs bf16: raise here
        gram_fn = self._gram_fn(cfg)
        loss_fns = self._loss_fns(cfg)

        def objective(image, c_targets, s_targets):
            feats, grams = self._vgg(cfg, image, cfg.content_layers, cfg.style_layers)
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
        for scale in plan:
            if scale.index < resume_scale:
                continue
            h, w = scale.size
            content_s = imgio.resize_image(content_t, (h, w))
            c_targets = self._capture_content(cfg, content_s)
            gram_list: Dict[str, list] = {l: [] for l in cfg.style_layers}
            for st in style_ts:
                st_s = imgio.resize_image(st, _style_size(st.shape[1:3], (h, w), cfg.style_scale))
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

            # Nothing below writes a tensor in place (the optimizers return
            # new states), so an event keeps its chunk's own image, EMA and
            # state however many chunks run after it.
            prev_mean, stall = None, 0
            while done_iters < scale.iterations:
                n = min(cfg.chunk_size, scale.iterations - done_iters)
                t0 = time.perf_counter()
                rows = []
                for _ in range(n):
                    image, opt_state, aux = step(image, opt_state)
                    if averaging:
                        ema = cfg.avg_decay * ema + (1.0 - cfg.avg_decay) * image
                    rows.append(aux)
                # one host read per chunk; it waits for the chunk's device work
                losses = {
                    k: torch.stack([r[k] for r in rows]).cpu().numpy() for k in rows[0]
                }
                dt = time.perf_counter() - t0
                done_iters += n

                if cfg.debug_checks:
                    bad = {k: v for k, v in losses.items() if not np.isfinite(v).all()}
                    if bad:
                        raise FloatingPointError(
                            f"non-finite loss terms {sorted(bad)} at scale "
                            f"{scale.index} ({h}x{w}), iteration {done_iters}"
                        )

                # Early stop is decided BEFORE the callback, so the final event
                # of a run that stops early carries done=True.
                stop = False
                if cfg.stop_tol > 0:
                    mean_loss = float(np.mean(losses["loss"]))
                    if prev_mean is not None:
                        rel = abs(prev_mean - mean_loss) / max(abs(prev_mean), 1e-12)
                        stall = stall + 1 if rel < cfg.stop_tol else 0
                        stop = stall >= cfg.stop_patience
                    prev_mean = mean_loss

                if callback is not None:
                    snap = (ema if averaging else image)[0].clamp(0.0, 1.0)
                    callback(
                        ProgressEvent(
                            scale_index=scale.index,
                            num_scales=len(plan),
                            size=(h, w),
                            iteration=done_iters,
                            total_iterations=scale.iterations,
                            losses=losses,
                            its_per_sec=n / dt if dt > 0 else float("inf"),
                            get_image=lambda s=snap: s.cpu().numpy(),
                            done=scale.index == plan[-1].index
                            and (done_iters >= scale.iterations or stop),
                            get_state=functools.partial(
                                _resumable_state, image, opt_state, done_iters, scale.index,
                                ema if averaging else None),
                        )
                    )
                if stop:
                    break

        result = ema if averaging else image
        if output_dtype == "uint8":
            return imgio.quantize_u8(result).cpu().numpy()
        return np.clip(result[0].detach().cpu().numpy(), 0.0, 1.0)

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


def _resumable_state(image, opt_state, iteration, scale_index, ema) -> dict:
    """``ProgressEvent.get_state()``: the chunk's state as numpy arrays."""
    state = {
        "image": image.detach().cpu().numpy(),
        "opt_state_leaves": flatten_opt_state(opt_state),
        "scale_index": np.asarray(scale_index),
        "iteration": np.asarray(iteration),
    }
    if ema is not None:
        state["ema"] = ema.detach().cpu().numpy()
    return state
