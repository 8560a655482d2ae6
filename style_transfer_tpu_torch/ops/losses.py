"""Objective math: Gram matrices, content/style losses, TV (PyTorch port).

Counterpart of ``style_transfer_tpu/ops/losses.py`` with the same
normalizations: ``G = F^T F / (N*H*W)``, style and content losses are MSEs,
TV is the mean squared forward difference. Everything accumulates in
float32 whatever the activation dtype. These plain versions are the oracle
that the kernel paths (``ops/kernels``) are held against.

Left out: the TPU compile-ceiling H-chunking of ``gram_matrix``
(``FLAT_PAD_LIMIT``) and the ``optimization_barrier`` that stops XLA:TPU's
Gram rewrite — both exist only for the XLA:TPU toolchain.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch


def gram_matrix(feat: torch.Tensor, *, rows=None, hw=None) -> torch.Tensor:
    """(N, H, W, C) activations -> (C, C) float32 Gram / (N*H*W). A mesh
    shard's Gram: ``rows = (lo, hi)`` sums over rows ``[lo, hi)`` of H only
    (the shard's own rows, not its halo), and ``hw`` divides by that count
    (the whole image's H*W) in place of the rows summed."""
    if rows is not None:
        feat = feat[:, rows[0]:rows[1]]
    c = feat.shape[-1]
    f = feat.reshape(-1, c).to(torch.float32)
    return (f.T @ f) / float(f.shape[0] if hw is None else hw)


def content_loss(feat: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error between activations, fp32."""
    d = feat.to(torch.float32) - target.to(torch.float32)
    return torch.mean(d * d)


def style_loss(gram: torch.Tensor, target_gram: torch.Tensor) -> torch.Tensor:
    """Mean squared error between (C, C) Grams, fp32."""
    d = gram.to(torch.float32) - target_gram.to(torch.float32)
    return torch.mean(d * d)


def tv_sse(image: torch.Tensor) -> torch.Tensor:
    """The sum of the squared forward differences of an NHWC image, fp32:
    :func:`tv_loss` before its division (a mesh shard's part of it)."""
    x = image.to(torch.float32)
    dh = x[:, 1:, :, :] - x[:, :-1, :, :]
    dw = x[:, :, 1:, :] - x[:, :, :-1, :]
    return torch.sum(dh * dh) + torch.sum(dw * dw)


def tv_loss(image: torch.Tensor) -> torch.Tensor:
    """Isotropic squared total variation of an NHWC image, mean-normalized."""
    return tv_sse(image) / float(image.numel())


def blend_grams(grams: Sequence[torch.Tensor], weights: Sequence[float]) -> torch.Tensor:
    """Weighted blend of per-style Gram targets, weights normalized to sum 1."""
    w = torch.as_tensor(list(weights), dtype=torch.float32, device=grams[0].device)
    w = w / torch.sum(w)
    stacked = torch.stack([g.to(torch.float32) for g in grams])
    return torch.tensordot(w, stacked, dims=1)


def normalize_layer_weights(layers: Sequence[str], weights=None) -> Dict[str, float]:
    """Per-layer weight map, normalized to sum to 1 (uniform by default)."""
    if weights is None:
        weights = [1.0] * len(layers)
    if len(weights) != len(layers):
        raise ValueError(f"{len(layers)} layers but {len(weights)} weights")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("layer weights must sum to a positive value")
    return {l: float(w) / total for l, w in zip(layers, weights)}


def objective_terms(
    feats: Mapping[str, torch.Tensor],
    *,
    content_targets: Mapping[str, torch.Tensor],
    style_targets: Mapping[str, torch.Tensor],
    content_layer_weights: Mapping[str, float],
    style_layer_weights: Mapping[str, float],
    image: torch.Tensor,
    content_weight: float,
    style_weight: float,
    tv_weight: float,
    gram_fn=gram_matrix,
    content_loss_fn=None,
    style_loss_fn=None,
    tv_loss_fn=None,
    gram_overrides: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """All loss terms from a feature dict, as fp32 scalars. The hooks and
    ``gram_overrides`` (Grams already computed by a fused kernel, whose
    activations never materialize) are those of the JAX ``objective_terms``:
    ``gram_fn`` takes ``ops.kernels.gram.gram_matrix`` / ``pallas_gram``, and
    ``content_loss_fn``, ``style_loss_fn``, ``tv_loss_fn`` the fused losses of
    ``ops.kernels.epilogue``. On a mesh ``image`` may be the tuple of its row
    shards, for a ``tv_loss_fn`` that takes them
    (``ops.kernels.epilogue.make_sharded_tv_loss``); the terms are then
    summed on the first shard's device."""
    content_loss_fn = content_loss_fn or content_loss
    style_loss_fn = style_loss_fn or style_loss
    tv_loss_fn = tv_loss_fn or tv_loss
    gram_overrides = gram_overrides or {}
    # under a mesh ``image`` is the tuple of its row shards, which only the
    # TV hook reads; the terms are summed on the home device (its first shard's)
    home = (image[0] if isinstance(image, (tuple, list)) else image).device
    zero = torch.zeros((), dtype=torch.float32, device=home)
    c_loss = zero
    for layer, w in content_layer_weights.items():
        c_loss = c_loss + w * content_loss_fn(feats[layer], content_targets[layer])
    s_loss = zero
    for layer, w in style_layer_weights.items():
        g = gram_overrides.get(layer)
        if g is None:
            g = gram_fn(feats[layer])
        s_loss = s_loss + w * style_loss_fn(g, style_targets[layer])
    t_loss = tv_loss_fn(image)
    total = content_weight * c_loss + style_weight * s_loss + tv_weight * t_loss
    return {"loss": total, "content": c_loss, "style": s_loss, "tv": t_loss}
