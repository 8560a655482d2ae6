"""What one ``stylize`` call reported, kept for the comparison that decides
``correct``, from its progress events alone (``ProgressEvent.losses`` and
``ProgressEvent.get_state``, the resumable state in the checkpoint format).

Per scale: the TV term its first step reported, which reads the start
image alone; the state
(image and Adam's ``count``, ``mu``, ``nu``) at the start of its last chunk,
None where that chunk is the scale's first; the last chunk's reported
losses; and the state at its end, the scale's last image. For the call, the
uint8 result. ``get_state`` copies on the program's side stream once its
chunk has completed, and is called for two chunks a scale.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

HW = Tuple[int, int]
STEPS = 3


class State:
    """An image and Adam's state, host tensors."""

    def __init__(self, image, count, mu, nu):
        self.image, self.count, self.mu, self.nu = image, int(count), mu, nu

    @classmethod
    def of(cls, state: dict) -> "State":
        """From a ``get_state()`` mapping: optax's Adam leaves ``count, mu, nu``."""
        count, mu, nu = state["opt_state_leaves"]
        return cls(torch.from_numpy(np.asarray(state["image"], np.float32)), int(np.asarray(count)),
                   torch.from_numpy(np.asarray(mu, np.float32)),
                   torch.from_numpy(np.asarray(nu, np.float32)))


class Capture:
    def __init__(self, scales: Sequence[Tuple[HW, int]], chunk: int):
        self.scales = list(scales)
        self.chunk = int(chunk)
        self.first_tv: Dict[HW, float] = {}
        self.before: Dict[HW, Optional[State]] = {}
        self.last: Dict[HW, List[float]] = {}
        self.end: Dict[HW, State] = {}
        self.result: Optional[torch.Tensor] = None
        self.starts: Optional[List[Optional[torch.Tensor]]] = None  # see sources()

    def last_len(self, total: int) -> int:
        """Steps in a scale's last chunk."""
        return (total - 1) % self.chunk + 1

    def event(self, ev) -> None:
        hw, total = tuple(ev.size), int(ev.total_iterations)
        losses = [float(v) for v in ev.losses["loss"]]
        start = ev.iteration - len(losses)
        if start == 0:
            self.first_tv[hw] = float(ev.losses["tv"][0])
        if ev.iteration == total - self.last_len(total):
            self.before[hw] = State.of(ev.get_state())
        if ev.iteration == total:
            self.before.setdefault(hw, None)
            self.last[hw] = losses
            self.end[hw] = State.of(ev.get_state())

    def sources(self) -> List[Optional[torch.Tensor]]:
        """What each scale starts from: None for the content image at the
        first scale, else the last image of the scale before; ``starts``
        where set (a control that took the program's place for the scales'
        last chunks only)."""
        if self.starts is not None:
            return self.starts
        return [None] + [self.end[hw].image for hw, _ in self.scales[:-1]]
