"""The step entry of the PyTorch port: the twin of ``__graft_entry__.py``.

- :func:`entry` returns ``(train_step, example_args)``: one full optimizer
  step (VGG-19 forward and backward, the losses, the Adam update) of the
  flagship 512 px configuration, in bf16 on the card;
- :func:`build_step` builds that step at any size, device and dtype
  (``__graft_entry__._build_step`` without its ``mesh``);
- :func:`dryrun_multichip` is the mesh's dry run, ``parallel/dryrun.py``.

The step is the reference's: the plain VGG forward
(``models.vgg.extract_features``) to the content layer ``conv4_2`` and the
style layers ``conv1_1 .. conv5_1``, content weight 1, style weight 256, TV
weight 2, Adam at lr 0.05 through ``optim.make_step_fn``, the targets
captured once. Under ``use_fused`` the Grams go through
``ops.kernels.gram.gram_matrix`` (on the card the Gram kernel of
``csrc/gram.cu``, the port of ``pallas_gram``); without it through
``ops.losses.gram_matrix``.

The content, style and initial images are drawn with ``torch.rand`` from a
``torch.Generator`` seeded with 0: the same images run to run, but not the
reference's ``jax.random`` draw, which does not carry over.
``build_step(..., images=(content, style, image))`` takes them as arrays
instead, so a test can hand over the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from style_transfer_tpu_torch.models import vgg as vgg_mod
from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.ops.kernels import gram as KG
from style_transfer_tpu_torch.optim import OptimizerSpec, make_step_fn
from style_transfer_tpu_torch.utils import imgio

CONTENT_LAYERS = ("conv4_2",)
STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")

#: Where :func:`build_step` without a device finds no card.
NO_CUDA_MESSAGE = (
    "the step runs on an NVIDIA GPU by default and CUDA is not available; "
    'pass device="cpu" to build it on the CPU'
)


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CUDA_MESSAGE)
        device = "cuda"
    return torch.device(device)


def build_step(params, mean, std, size: Tuple[int, int], *,
               compute_dtype: Optional[torch.dtype] = None, use_fused: bool = True,
               pooling: str = "average", remat: bool = False, device=None,
               images: Optional[Sequence] = None):
    """``(train_step, (params, image, opt_state, c_targets, s_targets))``.

    ``train_step(params, image, opt_state, c_targets, s_targets) -> (image,
    opt_state, loss)`` runs one Adam step of the objective (module
    docstring). ``params`` is a ``{layer: {"kernel", "bias"}}`` dict of
    array-likes, copied to ``device`` (``None``: the card; without CUDA it
    raises, and the CPU is used only when asked with ``device="cpu"``).
    ``compute_dtype`` is the VGG's (``None``: the weights' fp32); the Gram
    kernel on the card takes bf16 only, so ``use_fused`` there needs
    ``torch.bfloat16``. ``images``: ``(content, style, image)`` as (1, H, W, 3)
    or (H, W, 3) arrays in [0, 1]; ``None`` draws them (module docstring).
    """
    device = _device(device)
    if use_fused and device.type == "cuda" and compute_dtype != torch.bfloat16:
        raise ValueError(f"the Gram kernel computes in bf16, got compute_dtype={compute_dtype}; "
                         "use compute_dtype=torch.bfloat16, or use_fused=False")
    h, w = size
    all_layers = tuple(dict.fromkeys(CONTENT_LAYERS + STYLE_LAYERS))
    gram_fn = KG.gram_matrix if use_fused else L.gram_matrix
    params = {name: {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
                     for k, v in p.items()} for name, p in params.items()}
    arch = vgg_mod.infer_arch(params)
    # made once on the device: an evaluation copies nothing from the host
    mean_t = torch.as_tensor(np.asarray(mean, np.float32)).to(device)
    std_t = torch.as_tensor(np.asarray(std, np.float32)).to(device)

    def features(p, image):
        x = imgio.preprocess(image, mean_t, std_t)
        return vgg_mod.extract_features(p, x, all_layers, pooling=pooling,
                                        compute_dtype=compute_dtype, arch=arch, remat=remat)

    if images is None:
        gen = torch.Generator().manual_seed(0)
        images = [torch.rand((1, h, w, 3), generator=gen) for _ in range(3)]
    content, style, image = (imgio.to_nhwc(a, device) for a in images)
    for name, t in (("content", content), ("style", style), ("image", image)):
        if tuple(t.shape) != (1, h, w, 3):
            raise ValueError(f"{name} image has shape {tuple(t.shape)}, expected (1, {h}, {w}, 3)")

    with torch.no_grad():
        c_feats, s_feats = features(params, content), features(params, style)
        c_targets = {l: c_feats[l] for l in CONTENT_LAYERS}
        s_targets = {l: gram_fn(s_feats[l]) for l in STYLE_LAYERS}

    c_w = L.normalize_layer_weights(CONTENT_LAYERS)
    s_w = L.normalize_layer_weights(STYLE_LAYERS)

    def objective(p, img, c_t, s_t):
        terms = L.objective_terms(
            features(p, img), content_targets=c_t, style_targets=s_t,
            content_layer_weights=c_w, style_layer_weights=s_w, image=img,
            content_weight=1.0, style_weight=256.0, tv_weight=2.0, gram_fn=gram_fn)
        return terms["loss"], terms

    spec = OptimizerSpec("adam", learning_rate=0.05)
    opt_state = spec.build().init(image)

    def train_step(p, img, state, c_t, s_t):
        step, _ = make_step_fn(lambda im: objective(p, im, c_t, s_t), spec)
        img, state, aux = step(img, state)
        return img, state, aux["loss"]

    return train_step, (params, image, opt_state, c_targets, s_targets)


def entry():
    """``(fn, example_args)``: the full step at 512 px, bf16, on the card."""
    from style_transfer_tpu_torch.models.weights import random_fixture

    params, mean, std = random_fixture(0)
    return build_step(params, mean, std, (512, 512), compute_dtype=torch.bfloat16,
                      use_fused=True)


def dryrun_multichip(n_devices: int):
    """The mesh's dry run (``parallel.dryrun.dryrun_multichip``) on
    ``n_devices`` shards of the visible cards, or of ``cuda:0`` repeated
    where fewer are visible (``python -m style_transfer_tpu_torch.parallel.
    dryrun N --repeat``). Without CUDA it raises; ``python -m
    style_transfer_tpu_torch.parallel.dryrun N --cpu`` runs it on CPU
    shards."""
    from style_transfer_tpu_torch.parallel import dryrun

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; python -m style_transfer_tpu_torch.parallel."
                           "dryrun N --cpu runs the dry run on CPU shards")
    devices = None if torch.cuda.device_count() >= n_devices else ["cuda:0"] * n_devices
    return dryrun.dryrun_multichip(n_devices, devices)
