"""The device trace of a traced run's slice, and what is read from it.

The profiler records the card's activity only (kernels, copies, fills), so
that it slows the host as little as it can; the benchmark's own host spans
(:class:`Spans`) are taken on the host's clock, which is the trace's, and
label the idle gaps. The card is synchronized before the profiler starts
and before it stops, so every device event of the slice lies inside it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


class Spans:
    """Host spans ``(label, start_ns, end_ns)`` on the trace's clock: each
    of the benchmark's calls into the program (a few thousand a run)."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def add(self, label: str, t0: int, t1: int) -> None:
        self.items.append((label, t0, t1))


class Profile:
    """A started ``torch.profiler`` session over the card's activity."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        self.prof.start()  # its own set-up (CUPTI's, seconds the first time) precedes the slice
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def events(self) -> List[Tuple[str, int, int]]:
        """``(name, start_ns, end_ns)`` of each device event."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        return out


def _union(events) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for _, s, t in sorted(events, key=lambda e: e[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def _label(mid: int, spans: List[Tuple[str, int, int]], default: str) -> str:
    """The shortest span holding ``mid`` (a dispatch or a callback inside the
    ``stylize`` call)."""
    holding = [(t - s, name) for name, s, t in spans if s <= mid <= t]
    return min(holding)[1] if holding else default


def summarize(events, window_s: float, spans: List[Tuple[str, int, int]],
              t0_ns: Optional[int] = None, t1_ns: Optional[int] = None,
              default: str = "harness") -> Dict:
    """Busy seconds (the union of the device intervals), kernel launches,
    every device operation's total seconds by name (``device_op_s``), the
    ``TOP`` of them that took most time and the longest idle gaps, each gap
    labelled by the innermost host span it fell in (``default``, the
    benchmark's own code, where none did). ``t0_ns``/``t1_ns``, the slice's
    ends on the trace's clock, add the gaps before the first and after the
    last device event."""
    union = _union(events)
    busy = sum(t - s for s, t in union) / 1e9
    kernels = sum(1 for name, _, _ in events if not name.startswith(("Memcpy", "Memset")))
    by_name: Dict[str, float] = {}
    for name, s, t in events:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
    edges = [(a[1], b[0]) for a, b in zip(union, union[1:])]
    if union and t0_ns is not None and t0_ns <= union[0][0] and union[-1][1] <= t1_ns:
        edges = [(t0_ns, union[0][0])] + edges + [(union[-1][1], t1_ns)]
    gaps = sorted(((_label((s + t) // 2, spans, default), (t - s) / 1e9) for s, t in edges if t > s),
                  key=lambda g: -g[1])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "kernels": kernels,
        "device_op_s": by_name,
        "device_ops": [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, v] for n, v in gaps[:TOP]],
    }
