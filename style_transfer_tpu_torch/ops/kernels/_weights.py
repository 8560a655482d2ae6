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
holds at most :data:`MAX_ENTRIES` entries (least recently used out first):
VGG-19 up to conv5_1 needs 13 taps in two forms and 13 biases.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

#: Most entries kept (least recently used out first).
MAX_ENTRIES = 64

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


_FORMS = {"bf16": as_bf16, "taps_t": transpose_taps}


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
    while len(_cache) > MAX_ENTRIES:
        _cache.popitem(last=False)
    return out


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Cached :func:`as_bf16` of a weight or bias tensor."""
    return _prepared(t, "bf16")


def taps_transposed(w: torch.Tensor) -> torch.Tensor:
    """Cached :func:`transpose_taps` of a (3, 3, Cin, Cout) weight tensor."""
    return _prepared(w, "taps_t")


def clear() -> None:
    """Drop every cached preparation (and the source tensors they hold)."""
    _cache.clear()
