"""The spans and launch counts of ``style_transfer_tpu_torch.trace``.

Off (no profiler, no ``trace.recording()``, no listener) a ``stylize`` call
records nothing. Under ``torch.profiler`` it records one span per layer
boundary of the stylize loop, on the profiler's own clock, with the same
bits as without. A listener sees each chunk's dispatch start and end.
``LaunchCount.add`` keeps ``n`` and counts by kernel and shape only while
recording. The ``cuda`` test holds the counts of one 512^2 Adam chunk to
the wrappers' ``n``; it runs on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q

The file imports neither JAX nor the JAX package.
"""

import contextlib
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from style_transfer_tpu_torch import StyleTransfer, StylizeConfig, cli, linesearch, trace
from style_transfer_tpu_torch.ops.kernels import block1, conv_gram, conv_pair, conv_single
from style_transfer_tpu_torch.ops.kernels import epilogue, gram
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.optim import OptimizerSpec
from style_transfer_tpu_torch.utils import imgio

#: Every wrapper's count, by the name it records under.
COUNTERS = {"conv_pair": conv_pair.launches, "conv_single": conv_single.launches,
            "gram_tail": conv_single.gram_tail_launches, "conv_gram": conv_gram.launches,
            "block1_packed": block1.launches, "block1_full": block1.full_launches,
            "block1_tail": block1.tail_launches, "gram": gram.launches, "tv": epilogue.launches,
            "content_loss": epilogue.content_launches, "style_loss": epilogue.style_launches,
            "linesearch.host_reads": linesearch.host_reads}

# 32 px over 16 -> 32: chunks of 2, 2, 1 at 16 px, then 2, 1
STEPS = [2, 2, 1, 2, 1]


@pytest.fixture(autouse=True)
def empty_trace():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def st():
    torch.set_num_threads(2)
    return StyleTransfer(device="cpu")


def _images(side=32):
    r = np.random.RandomState(3)
    return (r.rand(side, side, 3).astype(np.float32), r.rand(side, side, 3).astype(np.float32))


def _cfg(**kw):
    base = dict(size=32, min_scale=16, iterations=(5, 3), chunk_size=2,
                optimizer=OptimizerSpec("adam", learning_rate=0.05))
    base.update(kw)
    return StylizeConfig(**base)


def _stylize(st, cfg=None):
    """One call, uint8 out: (result, the events' losses)."""
    events = []
    out = st.stylize(*_images(), cfg or _cfg(), callback=events.append, output_dtype="uint8")
    return out, [ev.losses for ev in events]


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_nothing_records_when_off(st):
    assert not trace.active()
    _stylize(st)
    assert trace.spans() == [] and trace.counts() == {}


def test_a_profiled_call_records_each_layer_boundary(st):
    with profile(activities=[ProfilerActivity.CPU]):
        t_started = time.time_ns()
        _stylize(st)
    spans = trace.spans()
    by = {name: _named(spans, name) for name in
          ("stylize", "scale", "capture", "resize", "dispatch", "process", "fetch", "callback",
           "output")}
    assert {k: len(v) for k, v in by.items()} == {
        "stylize": 1, "scale": 2, "capture": 2, "resize": 2, "dispatch": 5, "process": 5,
        "fetch": 5, "callback": 5, "output": 1}
    assert len(spans) == sum(len(v) for v in by.values())
    [call] = by["stylize"]
    assert call.parent_id is None and call.attrs == {"sizes": [(16, 16), (32, 32)]}
    assert {s.call_id for s in spans} == {call.call_id} and call.call_id is not None
    scales = {s.span_id: s for s in by["scale"]}
    assert [s.attrs for s in by["scale"]] == [
        {"index": 0, "size": (16, 16), "iterations": 5},
        {"index": 1, "size": (32, 32), "iterations": 3}]
    assert all(s.parent_id == call.span_id for s in by["scale"] + by["output"])
    for name in ("capture", "resize", "dispatch", "process"):
        assert all(s.parent_id in scales for s in by[name]), name
    assert [len([s for s in by[n] if scales[s.parent_id].attrs["index"] == 0]) for n in
            ("capture", "resize", "dispatch", "process")] == [1, 1, 3, 3]
    process = {s.span_id for s in by["process"]}
    for name in ("fetch", "callback"):
        assert sorted(s.parent_id for s in by[name]) == sorted(process), name
    assert [s.attrs["steps"] for s in sorted(by["dispatch"], key=lambda s: s.t0_ns)] == STEPS
    assert all(s.t0_ns >= t_started for s in by["dispatch"])
    for s in spans:  # children inside their parents, on the caller's thread
        assert s.t0_ns <= s.t1_ns and s.thread_id == call.thread_id
        if s.parent_id is not None:
            parent = next(p for p in spans if p.span_id == s.parent_id)
            assert parent.t0_ns <= s.t0_ns and s.t1_ns <= parent.t1_ns


def test_a_profiler_started_by_a_dispatch_wrapper_records_that_chunk(st):
    """As the benchmark's traced slice: a wrapper of ``_dispatch_chunk``
    starts the profiler before chunk 2 and stops it before chunk 4, and the
    program's ``dispatch`` span opens inside the method's body."""
    real, seen, box = st._dispatch_chunk, [], {}

    def dispatch(*a, **kw):
        if len(seen) == 2:
            box["prof"] = profile(activities=[ProfilerActivity.CPU])
            box["prof"].start()
        elif len(seen) == 4:
            box["prof"].stop()
        seen.append(kw["n"])
        return real(*a, **kw)

    st._dispatch_chunk = dispatch
    try:
        _stylize(st)
    finally:
        del st._dispatch_chunk
    assert seen == STEPS
    dispatches = _named(trace.spans(), "dispatch")
    assert [s.attrs["steps"] for s in dispatches] == STEPS[2:4]
    # spans opened before the profiler (the call, its first scale) are not
    # recorded; the second scale opened after it started; one call id
    assert _named(trace.spans(), "stylize") == []
    assert [s.attrs["index"] for s in _named(trace.spans(), "scale")] == [1]
    assert dispatches[0].parent_id is None
    assert dispatches[1].parent_id == _named(trace.spans(), "scale")[0].span_id
    assert len({s.call_id for s in dispatches}) == 1 and dispatches[0].call_id is not None


def test_spans_lie_on_the_profilers_clock(st):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stylize(st)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == trace.PREFIX + "dispatch")
    spans = sorted(_named(trace.spans(), "dispatch"), key=lambda s: s.t0_ns)
    assert len(ranges) == len(spans) == len(STEPS)
    for (r0, r1), s in zip(ranges, spans):
        assert s.t0_ns <= r0 <= r1 <= s.t1_ns


@pytest.fixture
def one_thread():
    """One CPU thread: with two, this tiny call's plain path is not
    bit-reproducible from call to call (a last-bit difference now and then,
    which Adam's first steps widen), recording or not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_recording_changes_no_bit(st, one_thread):
    out_off, losses_off = _stylize(st)
    with trace.recording():
        recorded = _stylize(st)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _stylize(st)
    assert len(_named(trace.spans(), "stylize")) == 2
    for out_on, losses_on in (recorded, profiled):
        np.testing.assert_array_equal(out_on, out_off)
        assert len(losses_on) == len(losses_off) == len(STEPS)
        for on, off in zip(losses_on, losses_off):
            assert on.keys() == off.keys()
            for k in on:
                np.testing.assert_array_equal(on[k], off[k])


def test_a_listener_sees_each_dispatch_start_and_end_with_nothing_recorded(st):
    heard = []
    handle = trace.listen(lambda phase, name, attrs: heard.append((phase, name, dict(attrs))))
    try:
        _stylize(st)
    finally:
        handle.remove()
    dispatch = [(phase, attrs["steps"]) for phase, name, attrs in heard if name == "dispatch"]
    assert dispatch == [(phase, n) for n in STEPS for phase in ("start", "end")]
    assert ("start", "stylize") == heard[0][:2] and ("end", "stylize") == heard[-1][:2]
    assert trace.spans() == [] and trace.counts() == {}
    _stylize(st)  # removed: no more calls
    assert len([h for h in heard if h[1] == "dispatch"]) == 2 * len(STEPS)


def test_a_listener_can_record_one_chunk():
    """A listener entered at a span's start records that span: it runs
    before the span decides whether to record."""
    stack = contextlib.ExitStack()

    def listener(phase, name, attrs):
        if name == "dispatch" and phase == "start":
            stack.enter_context(trace.recording())
        elif name == "dispatch":
            stack.close()

    handle = trace.listen(listener)
    try:
        with trace.span("scale", index=0):
            with trace.span("dispatch", steps=3):
                pass
            with trace.span("process"):
                pass
    finally:
        handle.remove()
    assert [(s.name, s.attrs) for s in trace.spans()] == [("dispatch", {"steps": 3})]
    assert not trace.active()


def test_launch_count_keeps_n_and_counts_only_while_recording():
    count = LaunchCount("conv_pair")
    count.add("conv3x3_fwd", (16, 16, 3, 64, True, True, False))
    assert count.n == 1 and trace.counts() == {}
    with trace.recording():
        count.add("conv3x3_fwd", (16, 16, 3, 64, True, True, False))
        count.add("gram", (256, 64, 0, 0, 0))
        with trace.recording():  # nested blocks
            count.add("gram", (256, 64, 0, 0, 0))
        assert trace.active()
    assert not trace.active()
    with profile(activities=[ProfilerActivity.CPU]):
        count.add("gram", (256, 64, 0, 0, 0))
    count.add("gram", (256, 64, 0, 0, 0))
    assert count.n == 6
    assert trace.counts() == {("conv_pair", "conv3x3_fwd", (16, 16, 3, 64, True, True, False)): 1,
                              ("conv_pair", "gram", (256, 64, 0, 0, 0)): 3}
    n = count.n
    count.n = 0  # reset as before
    count.add("gram", (256, 64, 0, 0, 0))
    assert count.n == 1 and n == 6


def test_every_wrapper_count_is_named():
    assert {c.name: c for c in COUNTERS.values()} == COUNTERS


def test_reading_does_not_clear_and_clear_empties():
    with trace.recording():
        with trace.span("fetch"):
            trace.count("tv", "tv", (8, 24, 3))
    assert len(trace.spans()) == 1 and trace.spans() == trace.spans()
    assert trace.counts() == trace.counts() == {("tv", "tv", (8, 24, 3)): 1}
    trace.clear()
    assert trace.spans() == [] and trace.counts() == {}


def test_a_span_that_raises_is_recorded_and_closes():
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("scale", index=0):
                with trace.span("capture"):
                    raise ValueError("boom")
        with trace.span("output"):
            pass
    capture, scale, output = trace.spans()
    assert (capture.name, scale.name, output.name) == ("capture", "scale", "output")
    assert capture.parent_id == scale.span_id and output.parent_id is None


def test_the_cli_profile_carries_the_spans(tmp_path):
    r = np.random.RandomState(0)
    content, style = str(tmp_path / "c.png"), str(tmp_path / "s.png")
    imgio.save_image(r.rand(32, 32, 3).astype(np.float32), content)
    imgio.save_image(r.rand(32, 32, 3).astype(np.float32), style)
    prof = tmp_path / "trace"
    assert cli.main([content, style, "-o", str(tmp_path / "o.png"), "--profile-dir", str(prof),
                     "--size", "32", "--min-scale", "32", "--iterations", "4",
                     "--chunk-size", "2", "--content-layers", "conv2_2", "--style-layers",
                     "conv1_1", "conv2_1", "--random-weights", "--device", "cpu",
                     "--print-every", "100"]) == 0
    [path] = prof.glob("*.pt.trace.json")
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"]]
    assert names.count(trace.PREFIX + "dispatch") == 2
    for name in ("stylize", "scale", "capture", "resize", "process", "fetch", "callback",
                 "output"):
        assert trace.PREFIX + name in names, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_one_adam_chunk_counts_every_launch_by_kernel_and_shape(card):
    """One 512^2 Adam chunk of four steps, recorded by a listener from the
    dispatch's start to its end: the counts add up to the wrappers' ``n``
    over the chunk, a whole number of launches a step."""
    st = StyleTransfer(device=card)
    steps, stack, before, after = 4, contextlib.ExitStack(), {}, {}

    def listener(phase, name, attrs):
        if name != "dispatch":
            return
        if phase == "start":
            before.update({k: c.n for k, c in COUNTERS.items()})
            stack.enter_context(trace.recording())
        else:
            stack.close()
            torch.cuda.synchronize(card)
            after.update({k: c.n for k, c in COUNTERS.items()})

    content, style = _images(512)
    cfg = StylizeConfig(size=512, min_scale=512, iterations=(steps,), chunk_size=steps)
    handle = trace.listen(listener)
    try:
        st.stylize(content, style, cfg)
    finally:
        handle.remove()
    counts = trace.counts()
    by_wrapper = {}
    for (wrapper, kernel, shape), n in counts.items():
        assert kernel and isinstance(shape, tuple) and shape
        by_wrapper[wrapper] = by_wrapper.get(wrapper, 0) + n
    assert by_wrapper == {k: after[k] - before[k] for k in COUNTERS if after[k] > before[k]}
    total = sum(counts.values())
    assert total > 0 and total % steps == 0
