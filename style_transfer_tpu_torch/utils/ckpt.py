"""Checkpoint / resume for long multi-scale runs (PyTorch port).

Counterpart of ``style_transfer_tpu/utils/ckpt.py``. A checkpoint is the
dict of ``ProgressEvent.get_state()``: the image, the optimizer state as a
list of leaves in optax's order (:func:`style_transfer_tpu_torch.optim.
state_leaves`), the scale index, the iteration and, with averaging, the EMA.
The leaves are numpy arrays, so the JAX package's ``get_state()`` resumes
the port as it is, and the port's resumes the JAX package.

:class:`CheckpointManager` keeps the reference's ``<dir>/step_<n>/`` layout;
each step directory holds one ``state.npz`` of numpy arrays (no orbax, no
pickle), written to a temporary name and renamed into place.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from style_transfer_tpu_torch.optim import replace_leaves, state_leaves
from style_transfer_tpu_torch.parallel import mesh as M
from style_transfer_tpu_torch.utils.progress import ProgressEvent

_STEP_RE = re.compile(r"^step_(\d+)$")
_LIST_RE = re.compile(r"^(.+)\.(\d+)$")
STATE_FILE = "state.npz"


def _is_array(leaf) -> bool:
    """A tensor leaf, or a mesh's tuple of row shards of one."""
    return isinstance(leaf, (torch.Tensor, tuple))


def _leaf_array(leaf) -> np.ndarray:
    """A state leaf as numpy: tensors as they are, row shards gathered by
    rows, host integers as int32."""
    if isinstance(leaf, tuple):
        leaf = M.gather_rows([s.detach() for s in leaf], "cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.int32)


def flatten_opt_state(opt_state, fetch=None) -> List[np.ndarray]:
    """The optimizer state's leaves, in optax's order, as numpy arrays; on
    a mesh, an image-sized leaf's row shards gathered along its row axis, so
    the leaves have the unsharded shapes. ``fetch`` copies a list of tensors
    (or tuples of shards) to numpy arrays (the optimize loop's copies on a
    side stream); by default each leaf's ``.cpu()``."""
    leaves = state_leaves(opt_state)
    if fetch is None:
        return [_leaf_array(l) for l in leaves]
    arrays = iter(fetch([l for l in leaves if _is_array(l)]))
    return [next(arrays) if _is_array(l) else _leaf_array(l) for l in leaves]


def restore_opt_state(template, leaves: List[np.ndarray]):
    """Graft saved leaves onto a freshly initialized optimizer state: each
    is cast to the template leaf's dtype, checked against its shape and put
    on its device; where the template leaf is a mesh's tuple of row shards,
    the saved (unsharded) leaf is cut into its shards' rows and devices."""
    t_leaves = state_leaves(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} optimizer-state leaves, expected "
            f"{len(t_leaves)} — optimizer config changed since the checkpoint?"
        )
    out = []
    for l, t in zip(leaves, t_leaves):
        if isinstance(t, tuple):
            ax = M.row_axis(t[0])
            shape = list(t[0].shape)
            shape[ax] = sum(int(s.shape[ax]) for s in t)
            if np.shape(l) != tuple(shape):
                raise ValueError(
                    f"checkpoint leaf shape {np.shape(l)} != expected {tuple(shape)} — "
                    "resuming at a different resolution/config is not supported"
                )
            out.append(M.shard_like(np.asarray(l), t))
            continue
        is_tensor = isinstance(t, torch.Tensor)
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype if is_tensor else np.int32
        cast = np.asarray(l).astype(dtype)
        shape = tuple(t.shape) if is_tensor else ()
        if cast.shape != shape:
            raise ValueError(
                f"checkpoint leaf shape {cast.shape} != expected {shape} — "
                "resuming at a different resolution/config is not supported"
            )
        if is_tensor:
            out.append(torch.tensor(cast, device=t.device))
        else:
            out.append(int(cast))
    return replace_leaves(template, out)


def _array(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _to_npz(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flat arrays for ``np.savez``: a list value ``k`` becomes ``k.0``,
    ``k.1``, ..., after an empty marker ``k.`` (so an empty list survives)."""
    flat = {}
    for k, v in state.items():
        if isinstance(v, (list, tuple)):
            flat[f"{k}."] = np.zeros(0, np.int8)
            flat.update({f"{k}.{i}": _array(a) for i, a in enumerate(v)})
        else:
            flat[k] = _array(v)
    return flat


def _from_npz(data) -> Dict[str, Any]:
    state: Dict[str, Any] = {}
    lists: Dict[str, Dict[int, np.ndarray]] = {}
    for k in data.files:
        if k.endswith("."):
            lists.setdefault(k[:-1], {})
            continue
        m = _LIST_RE.match(k)
        if m:
            lists.setdefault(m.group(1), {})[int(m.group(2))] = data[k]
        else:
            state[k] = data[k]
    for k, items in lists.items():
        state[k] = [items[i] for i in sorted(items)]
    return state


class CheckpointManager:
    """Saves periodic checkpoints; exposes a progress-callback sink.

    Layout: ``<dir>/step_<global_step>/state.npz``; ``latest()`` picks the
    highest step and ``keep`` bounds how many stay.
    """

    def __init__(self, directory: str, every: int = 200, keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every = max(1, every)
        self.keep = max(1, keep)
        self._global_step = 0
        self._last_saved = -1

    # ------------------------------------------------------------- saving

    def callback(self, ev: ProgressEvent) -> None:
        if ev.get_state is None:
            return
        self._global_step += len(ev.losses["loss"])
        boundary = (self._global_step // self.every) * self.every
        if ev.done or (boundary > self._last_saved):
            self.save(ev.get_state(), self._global_step)
            self._last_saved = boundary

    def save(self, state: Dict[str, Any], step: int) -> None:
        path = os.path.join(self.directory, f"step_{step}")
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp.npz")
        np.savez(tmp, **_to_npz(state))
        os.replace(tmp, os.path.join(path, STATE_FILE))
        self._gc()

    def _gc(self) -> None:
        for s in sorted(self._list_steps())[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------ loading

    def _list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)):
                out.append(int(m.group(1)))
        return out

    def latest(self) -> Optional[Dict[str, Any]]:
        """The newest checkpoint as a dict of numpy arrays (list entries as
        lists), or None."""
        steps = self._list_steps()
        if not steps:
            return None
        path = os.path.join(self.directory, f"step_{max(steps)}", STATE_FILE)
        with np.load(path, allow_pickle=False) as data:
            return _from_npz(data)
