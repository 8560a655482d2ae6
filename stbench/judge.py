"""The comparison that decides ``correct``: the plain float32 reference
judges what one ``stylize`` call reported (a :class:`~stbench.capture.Capture`).

The reference (the Gatys objective on the configuration's architecture,
``arch``) makes its own targets and start images from the same seeded
weights and uint8 images the program was given, and takes its own Adam
steps; it reads the program's states only to start from them or to judge
them. Per scale, worst over the scales:

``start_tv``      the TV term the scale's first step reported against the
                  reference's TV of the scale's start: it reads the start
                  image alone, in float32 on both sides, so it checks the
                  resize between scales (and the first scale's start).
``end_loss``      the reported losses of the first three steps of the
                  scale's last chunk against the reference's along its own
                  steps from the program's state at that chunk's start
                  (image and Adam's moments and count): largest relative
                  error. The first is at the same image on both sides.
``end_change``    the norm of the image's change over that chunk against
                  the reference's over the same steps from the same state:
                  the gap of the norms, relative to the reference's.
``output``        the call's uint8 result against the reference's
                  quantization of the program's last image: elements that
                  differ.

In a steady cell the last chunk is the window's last; in a ladder it is
each scale's last. Not compared, since sound runs read as high as faults
do (PERF.md): the losses of a scale's first steps after the first, where
Adam's first steps, nearly signs, send the two sides apart, and the
gradients a chunk feeds Adam, late in a scale where they are small.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from stbench.capture import STEPS, Capture, State
from stbench.reference import optim as ref_optim
from stbench.reference import resize as R
from stbench.reference.objective import Objective, fp32, tv_loss

NUMBERS = ("start_tv", "end_loss", "end_change", "output")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float32)))


def _gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else float(a != 0)


def _adam(opt: dict, state: Optional[State] = None, device=None) -> ref_optim.Adam:
    """The reference's Adam for a configuration's ``optimizer`` mapping,
    fresh or from a program's ``state``."""
    if opt["name"] != "adam":
        raise ValueError(f"the reference judges Adam only, not {opt['name']!r}")
    args = (opt["learning_rate"], opt.get("beta1", 0.9), opt.get("beta2", 0.999),
            opt.get("eps", 1e-8))
    if state is None:
        return ref_optim.Adam(*args)
    return ref_optim.Adam(*args, count=state.count, mu=state.mu.to(device),
                          nu=state.nu.to(device))


def follow(obj: Objective, targets, adam: ref_optim.Adam, x: torch.Tensor,
           steps: int) -> Tuple[List[float], torch.Tensor]:
    """``steps`` Adam steps from ``x``: the loss at each step's start, and
    the image after the last."""
    losses = []
    for _ in range(steps):
        f, g = obj.value_and_grad(x, targets)
        losses.append(float(f))
        x = adam.step(x, g)
    return losses, x


def _targets(obj: Objective, fields: dict, c01, s01, style_hw, hw):
    return obj.targets(R.resize(c01, hw), R.resize(
        s01, R.style_size(style_hw, hw, fields.get("style_scale", 1.0))))


def judge(arch, fields: dict, capture: Capture, content: torch.Tensor, style: torch.Tensor,
          params, mean, std, device, details: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared, each worst over the scales; ``details``, where
    given, gets each scale's raw readings."""
    opt = fields["optimizer"]
    out = dict.fromkeys(NUMBERS, 0.0)
    with fp32():
        obj = Objective(arch, params, mean, std, fields)
        c01, s01 = R.from_u8(content.to(device)), R.from_u8(style.to(device))
        for (hw, _), src in zip(capture.scales, capture.sources()):
            tg = _targets(obj, fields, c01, s01, tuple(style.shape[:2]), hw)
            start = R.resize(c01 if src is None else src.to(device), hw)
            out["start_tv"] = max(out["start_tv"],
                                  _gap(capture.first_tv[hw], float(tv_loss(start))))
            before, end, last = capture.before[hw], capture.end[hw], capture.last[hw]
            x0 = start if before is None else before.image.to(device)
            ref, x = follow(obj, tg, _adam(opt, before, device), x0, len(last))
            change, ref_change = _norm(end.image.to(device) - x0), _norm(x - x0)
            out["end_loss"] = max([out["end_loss"]] +
                                  [_gap(p, r) for p, r in zip(last[:STEPS], ref)])
            out["end_change"] = max(out["end_change"], _gap(change, ref_change))
            if details is not None:
                with torch.no_grad():
                    start_loss = float(obj.terms(start, tg)["loss"])
                details["x".join(map(str, hw))] = {
                    "losses": last[:STEPS], "ref_losses": ref[:STEPS], "change": change,
                    "ref_change": ref_change, "ref_start_loss": start_loss,
                    "count": None if before is None else before.count}
            del tg, x
        last_image = capture.end[capture.scales[-1][0]].image.to(device)
        out["output"] = float((R.quantize(last_image) != capture.result.to(device)).sum())
    return out


def control_capture(arch, program: Capture, fields: dict, content: torch.Tensor,
                    style: torch.Tensor, params, mean, std, device, quant) -> Capture:
    """The control: the reference with ``quant`` rounding its arithmetic,
    put in the program's place for each scale's last chunk, from the
    program's own state at that chunk's start, recorded as the program's
    call is; the scales start where the program's did."""
    opt = fields["optimizer"]
    cap = Capture(program.scales, program.chunk)
    cap.first_tv, cap.before = dict(program.first_tv), dict(program.before)
    cap.starts = program.sources()
    with fp32():
        obj = Objective(arch, params, mean, std, fields, quant=quant)
        c01, s01 = R.from_u8(content.to(device)), R.from_u8(style.to(device))
        for (hw, _), src in zip(program.scales, cap.starts):
            tg = _targets(obj, fields, c01, s01, tuple(style.shape[:2]), hw)
            before = program.before[hw]
            x = (R.resize(c01 if src is None else src.to(device), hw) if before is None
                 else before.image.to(device))
            adam = _adam(opt, before, device)
            cap.last[hw], x = follow(obj, tg, adam, x, len(program.last[hw]))
            cap.end[hw] = State(x.cpu(), adam.count, adam.mu.cpu(), adam.nu.cpu())
            del tg, x, adam
        cap.result = R.quantize(cap.end[program.scales[-1][0]].image)
    return cap


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """``{name: [value, limit]}`` of each number the cell compares: those
    its ``limits`` name; a value that is not finite as its string, which
    JSON can carry."""
    return {k: [v if math.isfinite(v) else str(v), limits[k]] for k, v in numbers.items()
            if k in limits}


def passes(numbers: Dict[str, float], limits: Dict[str, float],
           failed: int = 0) -> bool:
    return failed == 0 and all(numbers[k] <= limits[k] for k in numbers if k in limits)
