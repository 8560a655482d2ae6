"""The per-layer metrics read from the program's own spans and launch
counts (``style_transfer_tpu_torch.trace``), each on a synthetic recording:
the number, nothing without a recording, nothing on the other loop, and
nothing from a program that has no such module."""

import sys

import pytest

from stbench import manifest
from style_transfer_tpu_torch import trace

MS = 1_000_000
STEADY = {"loop": "steady", "slice": {"iterations": 100, "busy_s": 2.9, "window_s": 3.0,
                                      "kernels": 15712}}
LADDER = {"loop": "ladder", "images": 4, "window_s": 26.0}


def _span(name, t0_ms, t1_ms, span_id, parent_id, call_id, **attrs):
    return trace.Span(name, t0_ms * MS, t1_ms * MS, span_id, parent_id, call_id, 1, attrs)


def _image(call, first_id):
    """The spans of one two-scale ``stylize`` call, ``first_id`` its first
    span's id: scale 0 with dispatches of 25 and 10 steps (50 and 30 ms),
    scale 1 with one of 25 (200 ms); captures of 12 and 30 ms."""
    i = first_id
    return [
        _span("capture", 0, 12, i + 2, i + 1, call),
        _span("dispatch", 13, 63, i + 3, i + 1, call, steps=25),
        _span("dispatch", 63, 93, i + 4, i + 1, call, steps=10),
        _span("fetch", 93, 100, i + 6, i + 5, call),
        _span("process", 93, 101, i + 5, i + 1, call),
        _span("scale", 0, 101, i + 1, i, call, index=0, size=(256, 256), iterations=35),
        _span("capture", 101, 131, i + 8, i + 7, call),
        _span("dispatch", 131, 331, i + 9, i + 7, call, steps=25),
        _span("scale", 101, 340, i + 7, i, call, index=1, size=(512, 512), iterations=25),
        _span("output", 340, 345, i + 10, i, call),
        _span("stylize", 0, 345, i, None, call, sizes=[(256, 256), (512, 512)]),
    ]


COUNTS = {("conv_pair", "conv3x3_fwd", (512, 512, 64, 64, True, True, False)): 400,
          ("gram", "gram", (262144, 64, 0, 0, 0)): 200,
          ("tv", "tv", (512, 1536, 3)): 100,
          ("linesearch.host_reads", "cond", ()): 7}


@pytest.fixture
def recorded(monkeypatch):
    """Installs a synthetic recording: ``recorded(spans, counts)``."""
    def install(spans=(), counts=None):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
        monkeypatch.setattr(trace, "counts", lambda: dict(counts or {}))
    return install


def test_dispatch_ms_per_it_reads_the_last_images_first_scale(recorded):
    # an earlier call's spans (another image) must not count
    recorded(_image(1, 1) + _image(2, 100))
    read = manifest.metric_reader("dispatch_ms_per_it.ladder")
    assert read(LADDER) == pytest.approx((50 + 30) / (25 + 10))


def test_capture_ms_per_image_sums_the_last_images_captures(recorded):
    recorded(_image(1, 1) + _image(2, 100))
    assert manifest.metric_reader("capture_ms_per_image.ladder")(LADDER) == pytest.approx(42.0)


def test_kernel_launches_per_it_leaves_the_host_reads_out(recorded):
    recorded(counts=COUNTS)
    read = manifest.metric_reader("kernel_launches_per_it.steady")
    assert read(STEADY) == pytest.approx(7.0)


@pytest.mark.parametrize("name, run", [("dispatch_ms_per_it.ladder", LADDER),
                                       ("capture_ms_per_image.ladder", LADDER),
                                       ("kernel_launches_per_it.steady", STEADY)])
def test_nothing_recorded_or_the_other_loop_reads_nothing(recorded, name, run):
    read = manifest.metric_reader(name)
    recorded()
    assert read(run) is None
    recorded(_image(1, 1), COUNTS)
    assert read(LADDER if run is STEADY else STEADY) is None
    # a recording of the other kind only
    if run is LADDER:
        recorded(counts=COUNTS)
    else:
        recorded(_image(1, 1))
    assert read(run) is None


def test_the_steady_reader_needs_the_profiled_slice(recorded):
    recorded(counts=COUNTS)
    read = manifest.metric_reader("kernel_launches_per_it.steady")
    assert read({"loop": "steady"}) is None


@pytest.mark.parametrize("name, run", [("dispatch_ms_per_it.ladder", LADDER),
                                       ("capture_ms_per_image.ladder", LADDER),
                                       ("kernel_launches_per_it.steady", STEADY)])
def test_a_program_without_the_trace_module_reads_nothing(recorded, monkeypatch, name, run):
    import style_transfer_tpu_torch

    recorded(_image(1, 1), COUNTS)
    assert manifest.metric_reader(name)(run) is not None
    # the parent of the change that added the module: importing it fails
    monkeypatch.delattr(style_transfer_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "style_transfer_tpu_torch.trace", None)
    assert manifest.metric_reader(name)(run) is None


def test_a_real_recording_reads_through_the_program(monkeypatch):
    """The readers on spans and counts the program's own API recorded."""
    trace.clear()
    try:
        with trace.recording():
            with trace.call(sizes=[(16, 16)]):
                with trace.span("scale", index=0, size=(16, 16), iterations=3):
                    with trace.span("capture"):
                        pass
                    with trace.span("dispatch", steps=3):
                        trace.count("conv_pair", "conv3x3_fwd", (16, 16, 3, 64, True, True, False))
        assert manifest.metric_reader("dispatch_ms_per_it.ladder")(LADDER) > 0
        assert manifest.metric_reader("capture_ms_per_image.ladder")(LADDER) > 0
        steady = {"loop": "steady", "slice": {"iterations": 3}}
        assert manifest.metric_reader("kernel_launches_per_it.steady")(steady) == pytest.approx(1 / 3)
    finally:
        trace.clear()
