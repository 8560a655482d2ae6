"""Periodic in-progress image snapshots (PyTorch port).

Counterpart of ``style_transfer_tpu/utils/snapshots.py``: the CLI's
``--snapshot-every``.
"""

from __future__ import annotations

import os

from style_transfer_tpu_torch.utils import imgio
from style_transfer_tpu_torch.utils.progress import ProgressEvent


class SnapshotSaver:
    """Saves the in-progress image every N iterations next to the output path.

    ``out.png`` -> ``out_snapshot.png``, overwritten at each save.
    """

    def __init__(self, output_path: str, every: int = 100):
        base, ext = os.path.splitext(output_path)
        self.path = f"{base}_snapshot{ext or '.png'}"
        self.every = max(1, every)
        self._last_saved = -1

    def __call__(self, ev: ProgressEvent) -> None:
        # Save on crossing each `every` boundary within a scale, and on the
        # final event; chunk sizes need not align with `every`.
        boundary = (ev.iteration // self.every) * self.every
        if ev.done or (boundary > self._last_saved and boundary > 0):
            imgio.save_image(ev.get_image(), self.path)
            self._last_saved = boundary
