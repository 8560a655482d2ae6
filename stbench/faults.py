"""Faults planted in the program under test, to show that the comparison
catches them (``control.py --fault``, ``tests/test_stbench_faults.py``).

Each is a context manager that patches ``style_transfer_tpu_torch.api``
and restores it on exit:

``unchanged``  every optimizer step returns the image it was given;
``freeze_late`` the same from the second chunk of each scale on (the first
               chunk's ``chunk`` steps move the image), as a step that
               replays stale state would;
``half_rows``  the objective sees the top half of the image's rows only
               (the mean taken over them), the image's share of "half of
               the batch left out";
``output``     one element of the uint8 result altered where it is made;
``resize``     the between-scale and target resizes bilinear, not Lanczos-3.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged(make_step_fn):
    def make(objective, spec):
        step, optimizer = make_step_fn(objective, spec)

        def frozen(image, state):
            _, state, aux = step(image, state)
            return image, state, aux

        return frozen, optimizer

    return make


def _freeze_late(make_step_fn, chunk: int):
    def make(objective, spec):
        step, optimizer = make_step_fn(objective, spec)
        calls = [0]

        def late(image, state):
            calls[0] += 1
            new, state, aux = step(image, state)
            return (new if calls[0] <= chunk else image), state, aux

        return late, optimizer

    return make


def _half_rows(build):
    def objective_of(self, cfg):
        objective = build(self, cfg)

        def half(image, c, s):
            return objective(image[:, : image.shape[1] // 2],
                             {k: v[:, : v.shape[1] // 2] for k, v in c.items()}, s)

        return half

    return objective_of


def _altered(quantize):
    def altered(image):
        q = quantize(image).clone()
        q[0, 0, 0] += 1
        return q

    return altered


def _bilinear(resize):
    def bilinear(image, size, method="lanczos3"):
        return resize(image, size, method="linear")

    return bilinear


def plant(name: str, chunk: int = 1):
    """The context manager of fault ``name``; ``chunk`` is the cell's chunk
    size."""
    from style_transfer_tpu_torch import api

    if name == "unchanged":
        return _patched(api, "make_step_fn", _unchanged(api.make_step_fn))
    if name == "freeze_late":
        return _patched(api, "make_step_fn", _freeze_late(api.make_step_fn, chunk))
    if name == "half_rows":
        return _patched(api.StyleTransfer, "_build_objective",
                        _half_rows(api.StyleTransfer._build_objective))
    if name == "output":
        return _patched(api.imgio, "quantize_u8", _altered(api.imgio.quantize_u8))
    if name == "resize":
        return _patched(api.imgio, "resize_image", _bilinear(api.imgio.resize_image))
    raise ValueError(f"unknown fault {name!r}")


NAMES = ("unchanged", "freeze_late", "half_rows", "output", "resize")
