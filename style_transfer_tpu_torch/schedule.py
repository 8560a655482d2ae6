"""Coarse-to-fine multi-scale schedule (PyTorch port).

Counterpart of ``style_transfer_tpu/schedule.py`` (``_round_even``,
``scale_ladder``, ``chunk_lengths``, ``build_plan``). Left out:
``snap_to_fused_grid`` and ``grid_snap`` — the TPU kernels' 16-row sublane
grid. The Hopper kernels take any even size (odd extents fall back to the
plain path for the segment that needs evenness), so the port's ladder is
the exact one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from style_transfer_tpu_torch.utils.imgio import scale_size


def _round_even(x: float) -> int:
    """Round to a multiple of 2 (>= 8) — friendly to VGG's pooling halvings."""
    return max(8, int(round(x / 2.0)) * 2)


@dataclasses.dataclass(frozen=True)
class Scale:
    index: int
    size: Tuple[int, int]  # (H, W)
    iterations: int


def scale_ladder(
    end_size: Tuple[int, int], *, min_scale: int = 256, factor: float = 2.0
) -> List[Tuple[int, int]]:
    """Sizes coarse->fine: the long side grows by ``factor`` up to
    ``end_size``, starting from the smallest ``end/factor^k >= min_scale``."""
    if factor <= 1.0:
        raise ValueError("scale factor must be > 1")
    longs = [max(end_size)]
    while longs[-1] / factor >= min_scale:
        longs.append(longs[-1] / factor)
    longs.reverse()
    out: List[Tuple[int, int]] = []
    for s in longs:
        h, w = scale_size(end_size, int(round(s)))
        size = (_round_even(h), _round_even(w))
        if not out or size != out[-1]:  # tiny images can collapse to one size
            out.append(size)
    return out


def chunk_lengths(iterations: int, chunk_size: int) -> List[int]:
    """Chunk lengths of one scale: ``chunk_size`` repeated, then the rest."""
    if iterations <= 0:
        return []
    full, rem = divmod(iterations, chunk_size)
    return [chunk_size] * full + ([rem] if rem else [])


def build_plan(
    end_size: Tuple[int, int],
    iterations: Sequence[int],
    *,
    min_scale: int = 256,
    factor: float = 2.0,
) -> List[Scale]:
    """The static plan; ``iterations`` applies coarse->fine, last entry repeats."""
    if not iterations:
        raise ValueError("need at least one iteration count")
    sizes = scale_ladder(end_size, min_scale=min_scale, factor=factor)
    return [
        Scale(index=i, size=size, iterations=int(iterations[min(i, len(iterations) - 1)]))
        for i, size in enumerate(sizes)
    ]
