"""Size-dependent choice of the kernel form for each segment of the chain.

Counterpart of the size rule of ``style_transfer_tpu/ops/pallas/vmem.py``
(``segment_impl`` :261-307, ``conv_gram_fits``/``gram_tail_impl``
:332-353), with the reference's thresholds. The rule depends only on the
effective width ``eff = w * c / 64`` of a segment's activation:

- a two-conv segment (conv a: cin -> cmid [+Gram], conv b: cmid -> cmid
  [+pool]) runs as the fused pair below ``eff = PAIR_EFF_LIMIT`` and as two
  singles from there on (``conv_single.make_pair_of_singles``);
- a Gram-only conv tail (conv5_1) runs ``conv_gram`` up to ``eff =
  PAIR_EFF_LIMIT`` and ``conv_single.gram_tail`` beyond it.

Not ported: the VMEM byte model, the 16-column alignment gate and the W
slice count — they describe the TPU's 16 MiB scoped VMEM and its sublane
tiling, which Hopper does not have (ROADMAP.md). Two departures follow:

- the reference's ``"wide"`` arm (eff > 4096, W-sliced singles) runs
  unsliced singles here: the Hopper kernels tile W in their grid;
- beyond ``vmem.block1_fits`` the reference runs block 1 on XLA; here the
  block-1 kernel still carries it, because on the card a plain fallback is
  not allowed and the kernel has no width limit there.
"""

from __future__ import annotations

#: Effective width (w * c / 64) from which a two-conv segment runs as
#: singles, and beyond which conv5_1's Gram tail leaves ``conv_gram``.
PAIR_EFF_LIMIT = 2048


def _eff(w: int, c: int) -> int:
    return w * c // 64


def segment_impl(w: int, cin: int, cmid: int, *, pool: bool, gram: bool) -> str:
    """``"pair"`` or ``"singles"`` for a two-conv segment whose activations
    are ``w`` wide with ``cmid`` channels (``cin``, ``pool`` and ``gram`` do
    not change the choice, as in the reference)."""
    del cin, pool, gram
    return "pair" if _eff(w, cmid) < PAIR_EFF_LIMIT else "singles"


def gram_tail_impl(w: int, cout: int) -> str:
    """``"conv_gram"`` or ``"gram_tail"`` for a Gram-only conv tail."""
    return "conv_gram" if _eff(w, cout) <= PAIR_EFF_LIMIT else "gram_tail"
