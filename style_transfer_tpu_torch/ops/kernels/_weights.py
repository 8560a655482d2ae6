"""Conv weights in the form the kernels read, prepared once per tensor.

``csrc/conv3x3.cu`` reads the taps as they lie in memory — (3, 3, K, N) bf16,
N contiguous — so it needs no packing of its own, but every launch needs the
bf16 copy of the fp32 weights, and backward-data needs the flipped,
channel-swapped taps (:func:`transpose_taps`). Both used to be recomputed on
every call (about 0.25 ms of a 512 px step on an H100). Here each is made
once per weight tensor and kept.

The cache is keyed on the tensor's ``data_ptr()``, ``_version``, shape,
strides, dtype and device, and each entry keeps its source tensor alive, so
the address cannot be reused by another tensor while the entry lives. An
in-place update bumps ``_version`` and yields a new preparation. The cache
holds at most :data:`MAX_ENTRIES` entries per device (the least recently
used entry of that device out first): VGG-19 up to conv5_1 needs 13 taps in
two forms and 13 biases on each card (39); the one-pass block-1 kernels add
conv1_1's padded (32, 64) taps and two fp32 biases. ResNet-50 needs 53
kernels in two forms (the 1x1 and strided ones as GEMM operands,
:func:`gemm` and :func:`gemm_t`; the stride-1 3x3s as taps) and 53 biases:
159 entries, so the cache keeps :data:`MAX_ENTRIES` of them. A mesh over N distinct
cards (``parallel/mesh.py``) keeps each card's weights there, so the cache
holds N such sets, and no card's entries evict another's.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

#: Most entries kept per device (least recently used out first).
MAX_ENTRIES = 192

_cache: "OrderedDict[tuple, tuple]" = OrderedDict()

#: Preparations made so far (cache misses); tests read it.
preparations = 0


def as_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous bf16 tensor (``t`` itself if it is one)."""
    return t.to(torch.bfloat16).contiguous()


def transpose_taps(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO taps -> the backward-data operand (3, 3, Cout,
    Cin): spatially flipped, channels swapped, bf16, contiguous. Applying it
    twice gives back the bf16 taps."""
    return w.flip(0, 1).transpose(2, 3).to(torch.bfloat16).contiguous()


def pad_conv1_taps(k1: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, 64) HWIO taps of conv1_1 -> the (32, 64) bf16 operand of
    ``csrc/block1.cu``: row ``(dy * 3 + dx) * 3 + ci`` holds that tap's 64
    output channels, rows 27..31 are zero (the contraction is padded to two
    k16 steps). The forward reads it as [k][n]; the backward's 27-wide
    product reads the same bytes as [n][k]."""
    out = torch.zeros((32, k1.shape[3]), dtype=torch.bfloat16, device=k1.device)
    out[:27] = k1.reshape(27, k1.shape[3]).to(torch.bfloat16)
    return out


def gemm_operand(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, Cin, Cout) HWIO taps -> the (Kp, Cout) bf16 operand of
    ``csrc/conv1x1.cu``: row ``(ky * kw + kx) * Cin + ci`` holds that tap's
    output channels, the order ``csrc/im2col.cu`` lays an input pixel's
    columns in; rows beyond kh kw Cin, up to the next multiple of 8
    (``Kp``), are zero."""
    k = w.shape[0] * w.shape[1] * w.shape[2]
    out = torch.zeros((-(-k // 8) * 8, w.shape[3]), dtype=torch.bfloat16, device=w.device)
    out[:k] = w.reshape(k, w.shape[3]).to(torch.bfloat16)
    return out


def gemm_operand_t(w: torch.Tensor) -> torch.Tensor:
    """The backward-data operand: :func:`gemm_operand` transposed, (Cout,
    Kp) bf16, contiguous."""
    return gemm_operand(w).T.contiguous()


def as_fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous fp32 tensor (``t`` itself if it is one)."""
    return t.to(torch.float32).contiguous()


_FORMS = {"bf16": as_bf16, "taps_t": transpose_taps, "conv1_taps": pad_conv1_taps,
          "fp32": as_fp32, "gemm": gemm_operand, "gemm_t": gemm_operand_t}


def _prepared(t: torch.Tensor, form: str) -> torch.Tensor:
    global preparations
    key = (form, t.data_ptr(), t._version, tuple(t.shape), t.stride(), t.dtype, str(t.device))
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit[1]
    with torch.no_grad():
        out = _FORMS[form](t)
    preparations += 1
    _cache[key] = (t, out)  # the source stays alive: its address stays its own
    same_device = [k for k in _cache if k[-1] == key[-1]]  # oldest first
    if len(same_device) > MAX_ENTRIES:
        del _cache[same_device[0]]
    return out


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Cached :func:`as_bf16` of a weight or bias tensor."""
    return _prepared(t, "bf16")


def taps_transposed(w: torch.Tensor) -> torch.Tensor:
    """Cached :func:`transpose_taps` of a (3, 3, Cin, Cout) weight tensor."""
    return _prepared(w, "taps_t")


def conv1_taps(k1: torch.Tensor) -> torch.Tensor:
    """Cached :func:`pad_conv1_taps` of conv1_1's (3, 3, 3, 64) weight tensor."""
    return _prepared(k1, "conv1_taps")


def gemm(w: torch.Tensor) -> torch.Tensor:
    """Cached :func:`gemm_operand` of an HWIO weight tensor."""
    return _prepared(w, "gemm")


def gemm_t(w: torch.Tensor) -> torch.Tensor:
    """Cached :func:`gemm_operand_t` of an HWIO weight tensor."""
    return _prepared(w, "gemm_t")


def fp32(t: torch.Tensor) -> torch.Tensor:
    """Cached :func:`as_fp32` of a bias (the block-1 kernels add it in fp32)."""
    return _prepared(t, "fp32")


def frozen(*weights: torch.Tensor) -> list:
    """The weights and biases detached: what a wrapper's plain version gets
    on a CPU tensor, so that it gives them no gradient (``None``), as the
    CUDA kernels give none. ``None`` is the PyTorch form of the reference's
    structural zero weight cotangent (``tests/test_weight_grads.py``)."""
    return [w.detach() for w in weights]


def clear() -> None:
    """Drop every cached preparation (and the source tensors they hold)."""
    _cache.clear()
