"""One run of one cell: the program under test, the spans the benchmark
takes around it, and what the loops record for the metrics.

The program is ``style_transfer_tpu_torch.api.StyleTransfer`` on weights
that the configuration's architecture draws from the seed, built with the
configuration's ``program`` arguments (the program infers the architecture
from the weights' names); every run goes through ``StyleTransfer.stylize``,
and what the comparison judges comes from its progress events
(:mod:`stbench.capture`). The benchmark's one hook into the program's
internals is :func:`watch_dispatch`: it tells the loops where each chunk is
queued, so that a steady window opens at the end of a call's first chunk
and a traced slice covers whole chunks, and it labels the trace's idle gaps.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from stbench import flops, inputs, tracing
from stbench.capture import Capture
from stbench.reference import resize as R


@dataclasses.dataclass
class Chunk:
    """What the loops keep of a progress event: host values only."""

    iteration: int
    size: Tuple[int, int]
    losses: Dict
    its_per_sec: float


def watch_dispatch(st, before: Callable[[], None], after: Callable[[], None]) -> None:
    """Calls ``before`` and ``after`` around each call of
    ``st._dispatch_chunk``, the method of ``StyleTransfer`` that queues one
    chunk of optimizer steps, once per chunk of every ``stylize`` call. Its
    arguments and result pass through unread. A program that stops calling
    it once per chunk fails ``tests/test_stbench_hook.py``."""
    real = st._dispatch_chunk

    @functools.wraps(real)
    def dispatch(*args, **kwargs):
        before()
        try:
            return real(*args, **kwargs)
        finally:
            after()

    st._dispatch_chunk = dispatch


class Run:
    def __init__(self, cell, seed: int, seconds: float, traced: bool, device: torch.device,
                 t_start: float):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.device, self.t_start = device, t_start
        self.cuda = device.type == "cuda"
        self.fields = cell.stylize()
        self.wl = cell.workload
        self.arch = cell.arch
        self.kind = torch.cuda.get_device_name(device) if self.cuda else "cpu"
        self.data: Dict = {"loop": self.wl["loop"],
                           "peak_flops": flops.peaks(self.kind).get("bf16_flops_per_s")}
        self.attempted = self.failed = 0
        self.spans = tracing.Spans()
        self.on_chunk: Optional[Callable] = None  # (chunk index in the call) before a dispatch
        self.chunks = 0  # chunks the current stylize call has queued
        self.checked = None  # (capture, image index) of the call the comparison judges
        self.profile: Optional[tracing.Profile] = None
        self.setup_s: Optional[float] = None
        self.window_t0: Optional[float] = None

    # ------------------------------------------------------------- program

    def build(self) -> None:
        from style_transfer_tpu_torch.api import StyleTransfer

        cfg = self.cell.config
        self.params = self.arch.weights(self.seed, self.device, cfg)
        self.mean, self.std = inputs.IMAGENET_MEAN, inputs.IMAGENET_STD
        self.st = StyleTransfer(self.params, mean=self.mean, std=self.std, device=self.device,
                                **cfg.get("program", {}))
        span = {}

        def before():
            if self.on_chunk is not None:
                self.on_chunk(self.chunks)
            span["t0"] = time.time_ns()

        def after():
            self.spans.add("dispatch", span.pop("t0"), time.time_ns())
            self.chunks += 1

        watch_dispatch(self.st, before, after)

    def scales(self, iterations) -> List:
        f = self.fields
        return R.ladder(tuple(self.wl["content_hw"]), int(f["size"]), iterations,
                        min_scale=int(f.get("min_scale", 256)),
                        factor=float(f.get("scale_factor", 2.0)))

    def config(self, iterations):
        from stbench.manifest import stylize_config

        return stylize_config({**self.fields, "iterations": list(iterations)})

    def new_capture(self, iterations) -> Capture:
        """A capture for a call of ``iterations``."""
        return Capture(self.scales(iterations), int(self.fields["chunk_size"]))

    def stylize(self, index: int, iterations, *, capture: Optional[Capture] = None,
                on_event=None):
        """One ``stylize`` call on the images of ``index``, uint8 out; with a
        ``capture``, what it reports is recorded there for the comparison."""
        content, style = inputs.images(self.seed, index, self.wl["content_hw"],
                                       self.wl["style_hw"], self.device)
        self.chunks = 0

        def callback(ev):
            # an event holds its chunk's device tensors (for get_image and
            # get_state): keep none of it, or the card's memory grows by a
            # chunk's image and optimizer state for every chunk of the call
            t0 = time.time_ns()
            if capture is not None:
                capture.event(ev)
            if on_event is not None:
                on_event(Chunk(ev.iteration, tuple(ev.size), ev.losses, ev.its_per_sec))
            self.spans.add("callback", t0, time.time_ns())

        t0 = time.time_ns()
        out = self.st.stylize(content, style, self.config(iterations), callback=callback,
                              output_dtype="uint8")
        self.spans.add("stylize", t0, time.time_ns())
        if capture is not None:
            capture.result = torch.from_numpy(out)
            self.checked = (capture, index)
        return out

    # -------------------------------------------------------------- window

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """Set-up ends here: the peak is reset and the window's clock starts."""
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.window_t0 = now
        return now

    def start_profile(self) -> None:
        if self.cuda:
            self.profile = tracing.Profile()

    def stop_profile(self) -> None:
        if self.profile is not None:
            self.profile.stop()

    def read_profile(self, iterations: int, flops: float) -> None:
        """The traced slice's busy time, launches and breakdown, read once
        the program has finished; ``iterations`` and model ``flops`` are
        the slice's."""
        p = self.profile
        if p is None:
            return
        summary = tracing.summarize(p.events(), p.t1 - p.t0, self.spans.items, p.t0_ns, p.t1_ns)
        summary.update(iterations=iterations, flops=flops)
        self.data["slice"] = summary
        self.profile = None

    def count_chunk(self, losses: Dict) -> bool:
        """Whether a chunk's losses are all finite."""
        return all(math.isfinite(float(v)) for vs in losses.values() for v in vs)

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def free_program(self) -> None:
        del self.st
        if self.cuda:
            torch.cuda.empty_cache()
