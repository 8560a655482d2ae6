"""Progress events, stdout reporting and iteration-rate metrics (PyTorch port).

Counterpart of ``style_transfer_tpu/utils/progress.py`` (``ProgressEvent``,
``Callback``, ``Printer``, ``MetricsRecorder``, ``fanout``); the optimize
loop emits one :class:`ProgressEvent` per chunk, whose ``get_state`` returns
the resumable state of that chunk (``utils/ckpt.py``). Left out:
``MetricsRecorder.dump`` (the CLI's ``--metrics-out``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ProgressEvent:
    """One per-chunk progress record from the optimize loop."""

    scale_index: int
    num_scales: int
    size: Tuple[int, int]
    iteration: int  # iterations completed at this scale (cumulative)
    total_iterations: int  # planned iterations at this scale
    losses: Dict[str, np.ndarray]  # per-iteration loss terms for this chunk
    # Wall-clock rate of this chunk (host clock, ending in the loss read,
    # which waits for the device). Each scale's FIRST chunk also carries the
    # target capture and first-launch costs; steady-state consumers drop it.
    its_per_sec: float
    # Fetches the current image as float RGB (H, W, 3) in [0, 1].
    get_image: Callable[[], np.ndarray]
    done: bool = False  # last event of the whole run
    # The resumable state at this chunk as numpy arrays: {"image",
    # "opt_state_leaves", "scale_index", "iteration"[, "ema"]}, the input of
    # stylize(resume_state=...) (utils/ckpt.py).
    get_state: Optional[Callable[[], dict]] = None

    @property
    def loss(self) -> float:
        return float(self.losses["loss"][-1])


Callback = Callable[[ProgressEvent], None]


class Printer:
    """Per-iteration stdout lines."""

    def __init__(self, every: int = 25, out=None):
        self.every = max(1, every)
        self.out = out

    def __call__(self, ev: ProgressEvent) -> None:
        n = len(ev.losses["loss"])
        start = ev.iteration - n
        for i in range(n):
            it = start + i + 1
            if it % self.every == 0 or (ev.done and i == n - 1):
                parts = [
                    f"scale {ev.scale_index + 1}/{ev.num_scales}",
                    f"{ev.size[1]}x{ev.size[0]}",
                    f"iter {it}/{ev.total_iterations}",
                    f"loss {float(ev.losses['loss'][i]):.6g}",
                    f"content {float(ev.losses['content'][i]):.4g}",
                    f"style {float(ev.losses['style'][i]):.4g}",
                    f"tv {float(ev.losses['tv'][i]):.4g}",
                    f"{ev.its_per_sec:.1f} it/s",
                ]
                print("  ".join(parts), flush=True, file=self.out)


class MetricsRecorder:
    """Accumulates per-chunk timing; :meth:`summary` gives steady per-scale rates."""

    def __init__(self):
        self.records: List[dict] = []

    def __call__(self, ev: ProgressEvent) -> None:
        self.records.append(
            {
                "scale": ev.scale_index,
                "size": list(ev.size),
                "iteration": ev.iteration,
                "loss": ev.loss,
                "its_per_sec": ev.its_per_sec,
                "time": time.time(),
            }
        )

    def summary(self) -> dict:
        """Steady-state per-scale rates: each scale's first chunk is dropped
        (it carries target capture and first launches); a scale with one
        chunk keeps it."""
        by_scale: Dict[int, List[float]] = {}
        for r in self.records:
            by_scale.setdefault(r["scale"], []).append(r["its_per_sec"])
        steady = {k: (v[1:] if len(v) > 1 else v) for k, v in by_scale.items()}
        return {
            "per_scale_its_per_sec": {k: float(np.mean(v)) for k, v in steady.items()},
            "per_scale_chunks_counted": {k: len(v) for k, v in steady.items()},
            "final_loss": self.records[-1]["loss"] if self.records else None,
        }


def fanout(*callbacks: Optional[Callback]) -> Callback:
    """Combine callbacks; Nones are skipped."""
    cbs = [c for c in callbacks if c is not None]

    def cb(ev: ProgressEvent) -> None:
        for c in cbs:
            c(ev)

    return cb
