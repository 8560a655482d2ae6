"""Each per-layer metric's reader on a synthetic run, and the reduction of
a device trace to busy time, launches and idle gaps."""

import pytest

from stbench import manifest, tracing

PEAK = 989e12
SLICE = {"iterations": 100, "flops": 100 * 6.35e12, "busy_s": 2.9, "window_s": 3.0,
         "kernels": 17000}
STEADY = {"loop": "steady", "peak_flops": PEAK, "window_its": 1000, "window_s": 31.0,
          "flops_per_it": 6.35e12, "slice": SLICE}
LADDER = {"loop": "ladder", "peak_flops": PEAK, "images": 4, "window_s": 26.0,
          "flops_per_image": 977e12, "slice": {**SLICE, "busy_s": 4.0, "window_s": 6.5}}
EXPECTED = {
    "launches_per_it.steady": (STEADY, 170.0),
    "mfu_pct.steady": (STEADY, 100 * 1000 * 6.35e12 / 31.0 / PEAK),
    "kernel_roofline_pct.steady": (STEADY, 100 * 100 * 6.35e12 / 2.9 / PEAK),
    "device_idle_pct.steady": (STEADY, 100 * (1 - 2.9 / 3.0)),
    "mfu_pct.ladder": (LADDER, 100 * 4 * 977e12 / 26.0 / PEAK),
    "device_idle_pct.ladder": (LADDER, 100 * (1 - 4.0 / 6.5)),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_run(name):
    run, want = EXPECTED[name]
    read = manifest.metric_reader(name)
    assert read(run) == pytest.approx(want)
    other = LADDER if run is STEADY else STEADY
    assert read(other) is None  # another loop's cell: nothing to read


@pytest.mark.parametrize("name", sorted(n for n in EXPECTED if not n.startswith("mfu")))
def test_reader_without_device_events_reads_nothing(name):
    run, _ = EXPECTED[name]
    assert manifest.metric_reader(name)({**run, "slice": {**run["slice"], "busy_s": 0.0}}) is None


def test_rates_of_a_peak_read_nothing_off_a_known_card():
    for name in ("mfu_pct.steady", "mfu_pct.ladder", "kernel_roofline_pct.steady"):
        run, _ = EXPECTED[name]
        assert manifest.metric_reader(name)({**run, "peak_flops": None}) is None


def test_summarize_a_synthetic_trace():
    ms = 1_000_000
    events = [("conv_fwd", 0, 4 * ms), ("gram", 3 * ms, 5 * ms), ("Memcpy DtoH", 7 * ms, 8 * ms),
              ("conv_fwd", 10 * ms, 12 * ms)]
    spans = [("stylize", 0, 12 * ms), ("dispatch", 5 * ms, 6 * ms), ("callback", 8 * ms, 11 * ms)]
    s = tracing.summarize(events, 0.013, spans, t0_ns=-1 * ms, t1_ns=13 * ms)
    assert s["busy_s"] == pytest.approx(0.008)
    assert s["kernels"] == 3
    assert s["device_ops"][0] == ["conv_fwd", pytest.approx(0.006)]
    gaps = sorted((n, round(v * 1e3, 6)) for n, v in s["idle_gaps"])
    # before the first event, 5-7 ms, 8-10 ms, after the last
    assert gaps == [("callback", 2.0), ("dispatch", 2.0), ("harness", 1.0), ("harness", 1.0)]


def test_summarize_keeps_ten_of_each():
    events = [(f"k{i}", 10 * i, 10 * i + 5) for i in range(30)]
    s = tracing.summarize(events, 1.0, [])
    assert len(s["device_ops"]) == tracing.TOP and len(s["idle_gaps"]) == tracing.TOP
    assert s["kernels"] == 30 and s["busy_s"] == pytest.approx(150e-9)


def test_the_slice_keeps_every_device_operations_time_by_name():
    """``device_op_s`` holds every operation's total seconds by name, summing
    to the events' total; the printed ten are its ten largest, as before."""
    ms = 1_000_000
    events = [(f"k{i % 13}", 10 * i * ms, (10 * i + 1 + i % 7) * ms) for i in range(40)]
    events += [("Memcpy DtoH", 500 * ms, 503 * ms), ("k0", 600 * ms, 602 * ms)]
    s = tracing.summarize(events, 1.0, [])
    by_name = s["device_op_s"]
    assert len(by_name) == 14
    assert sum(by_name.values()) == pytest.approx(sum(t - b for _, b, t in events) / 1e9)
    for name in by_name:
        assert by_name[name] == pytest.approx(
            sum(t - b for n, b, t in events if n == name) / 1e9)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:tracing.TOP]
    assert s["device_ops"] == [[n, v] for n, v in top]
    assert len(s["device_ops"]) == tracing.TOP
