"""The port's segment dispatch against the JAX package's, for large images.

For every scale of three ladders — the 2048 px and 4096 px squares and the
512x8192 panorama, from ``schedule.scale_ladder`` with min_scale 256 — the
port's :func:`dispatch.segment_impl` / :func:`dispatch.gram_tail_impl` must
give the reference's ``vmem.segment_impl`` / ``vmem.gram_tail_impl`` (with
the hardware gates, ``tpu=True``) under the stated mapping: ``"wide"`` runs
unsliced singles, and the reference's ``"single"`` tail is ``gram_tail``.
Where the reference's block-1 kernel no longer fits (``vmem.block1_fits``
is False), the port's chain still runs block 1 on its kernel.
"""

import pytest
import torch

from style_transfer_tpu import schedule as JS
from style_transfer_tpu.ops.pallas import vmem as VM
from style_transfer_tpu_torch import StyleTransfer
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import dispatch

SEGMENT_MAP = {"pair": "pair", "singles": "singles", "wide": "singles"}
TAIL_MAP = {"conv_gram": "conv_gram", "single": "gram_tail"}
LADDERS = {"2048_square": (2048, 2048), "4096_square": (4096, 4096),
           "panorama_512x8192": (512, 8192)}


def _scales(end):
    return JS.scale_ladder(end, min_scale=256)


def _segments(w_img):
    """(name, width of the segment's activation, cin, cmid, pool, gram) for
    the chain's two-conv segments at image width ``w_img``, as the JAX chain
    asks (``api.py:750-819``)."""
    w1, w2, w3 = w_img // 2, w_img // 4, w_img // 8
    return [("block2", w1, 64, 128, True, True), ("block3_front", w2, 128, 256, False, True),
            ("block3_tail", w2, 256, 256, True, False), ("block4_front", w3, 256, 512, False, True),
            ("block4_tail", w3, 512, 512, True, False)]


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_segment_choice_matches_reference(ladder):
    for h, w in _scales(LADDERS[ladder]):
        for name, ws, cin, cmid, pool, gram in _segments(w):
            ref = VM.segment_impl(ws, cin, cmid, pool=pool, gram=gram, tpu=True)
            assert ref in SEGMENT_MAP, (ladder, (h, w), name, ref)
            got = dispatch.segment_impl(ws, cin, cmid, pool=pool, gram=gram)
            assert got == SEGMENT_MAP[ref], (ladder, (h, w), name, ref, got)


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_gram_tail_choice_matches_reference(ladder):
    for h, w in _scales(LADDERS[ladder]):
        ref = VM.gram_tail_impl(w // 16, 512, tpu=True)
        assert ref in TAIL_MAP, (ladder, (h, w), ref)
        assert dispatch.gram_tail_impl(w // 16, 512) == TAIL_MAP[ref], (ladder, (h, w), ref)


@pytest.mark.parametrize(
    "size, segments, tail",
    [((512, 1024), "pair", "conv_gram"), ((2048, 2048), "singles", "conv_gram"),
     ((128, 2048), "singles", "conv_gram"), ((256, 4096), "singles", "conv_gram"),
     ((512, 8192), "singles", "gram_tail")],
)
def test_large_image_table(size, segments, tail):
    """The dispatch table of the large-image scales: singles from width 2048
    on, ``gram_tail`` at width 8192."""
    w = size[1]
    assert {dispatch.segment_impl(ws, cin, cmid, pool=p, gram=g)
            for _, ws, cin, cmid, p, g in _segments(w)} == {segments}
    assert dispatch.gram_tail_impl(w // 16, 512) == tail


def test_block1_stays_on_its_kernel_beyond_the_reference_envelope(monkeypatch):
    """At every ladder width where ``vmem.block1_fits`` is False the port's
    chain still enters block 1 through ``block1_packed`` (a 2-row image of
    that width keeps the CPU's work small)."""
    widths = sorted({w for end in LADDERS.values() for _, w in _scales(end)
                     if not VM.block1_fits(w, tpu=True)})
    assert 8192 in widths
    calls = []
    real = B1.block1_packed
    monkeypatch.setattr(B1, "block1_packed", lambda *a: calls.append(a[0].shape) or real(*a))
    st = StyleTransfer(device="cpu")
    for w in widths:
        with torch.no_grad():
            _, grams = st._chain_features(torch.rand(1, 2, w, 3), (), ("conv1_1", "conv2_1"))
        assert calls[-1] == (1, 2, w, 3) and "conv1_1" in grams
    assert len(calls) == len(widths)
