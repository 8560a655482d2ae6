"""One objective evaluation on a mesh against the same without a mesh.

Counterpart of ``__graft_entry__.dryrun_multichip``: the fused chain on an
N-device mesh, in four variants, each held against the unsharded chain on
the mesh's first device —

- ``pairs``: the default dispatch at a small size (block 1, block 2, the
  block-3/4 pairs, ``conv_gram``);
- ``singles``: every two-conv segment forced onto the pair of singles
  (``dispatch.segment_impl``), the form of the >= 2048 px scales;
- ``gram_tail``: the singles with conv5_1 forced onto ``gram_tail``
  (``dispatch.gram_tail_impl``), the form beyond conv_gram's range (the
  reference's ``chunked`` variant forces its W-chunked tap sums, which the
  port does not have: its kernels tile W in their grid);
- ``natural``: an image ``dispatch.PAIR_EFF_LIMIT`` wide (2048 px), at
  which the un-forced size rule picks the singles for blocks 2-4.

It compares the loss terms **and the image gradient** of one evaluation,
not post-step pixels: one Adam step turns gradient noise near zero into
whole-step pixel moves (the reference's weak point #4 in ``VERDICT.md``).

    python -m style_transfer_tpu_torch.parallel.dryrun 8            # 8 CUDA devices
    python -m style_transfer_tpu_torch.parallel.dryrun 8 --repeat   # cuda:0 eight times
    python -m style_transfer_tpu_torch.parallel.dryrun 8 --cpu      # eight CPU shards
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from style_transfer_tpu_torch.parallel import mesh as M

VARIANTS = ("pairs", "singles", "gram_tail", "natural")

#: Limits on the CPU, where both sides run the plain versions with the
#: convs in float64 (the Grams and losses in fp32), so that no ReLU flips on
#: a last-bit difference: in fp32 one flip deep in the chain moved the
#: gradient by 1.2e-4 relative on one seed of four, in float64 the mesh
#: departed by 7e-8 on all four.
CPU_TOL = {"terms": 1e-6, "grad": 1e-6, "cos": 1 - 1e-10}


def _image_size(variant: str, n: int):
    from style_transfer_tpu_torch.ops.kernels import dispatch

    h = M.ROW_GRAIN * max(n, 4)  # every level of the chain on every shard
    return (h, dispatch.PAIR_EFF_LIMIT) if variant == "natural" else (h, 64)


@contextlib.contextmanager
def _forced(variant: str):
    from style_transfer_tpu_torch.ops.kernels import dispatch

    saved = dispatch.segment_impl, dispatch.gram_tail_impl
    if variant in ("singles", "gram_tail"):
        dispatch.segment_impl = lambda *a, **k: "singles"
    if variant == "gram_tail":
        dispatch.gram_tail_impl = lambda *a, **k: "gram_tail"
    try:
        yield
    finally:
        dispatch.segment_impl, dispatch.gram_tail_impl = saved


def _expected_forms(variant: str):
    two_conv = "pair" if variant == "pairs" else "singles"
    tail = "gram_tail" if variant == "gram_tail" else "conv_gram"
    return {"block2": two_conv if variant != "natural" else "singles",
            "block4_tail": two_conv, "conv5_1": tail}


def _evaluate(st, cfg, content, style, image):
    """Loss terms and image gradient of one objective evaluation."""
    from style_transfer_tpu_torch.api import _style_size
    from style_transfer_tpu_torch.utils import imgio

    dev = st.device
    c = st._capture_content(cfg, torch.from_numpy(content)[None].to(dev))
    h, w = content.shape[:2]
    st_s = imgio.resize_image(torch.from_numpy(style)[None].to(dev),
                              _style_size(style.shape[:2], (h, w), cfg.style_scale))
    s = st._capture_style(cfg, st_s)
    x = torch.from_numpy(image)[None].to(dev).requires_grad_(True)
    loss, terms = st._build_objective(cfg)(x, c, s)
    (grad,) = torch.autograd.grad(loss, x)
    return ({k: float(v.detach()) for k, v in terms.items()}, grad.detach().double().cpu(),
            st.last_route)


def run_variant(variant: str, mesh: M.Mesh, params, mean, std, tol=None) -> Dict:
    """One variant (module docstring): the mesh's objective against the
    unsharded one on the mesh's home device. Raises AssertionError beyond
    ``tol`` (default: :data:`CPU_TOL` on the CPU, in float64, the card's
    limits of ``ops/kernels/tolerances.py`` on CUDA, in bf16) or where a segment took another
    form than the variant's."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.ops.kernels import tolerances as T

    if tol is None:
        tol = CPU_TOL if mesh.home.type == "cpu" else {
            "terms": T.TOL_MESH_TERMS, "grad": T.TOL_MESH_GRAD, "cos": T.TOL_MESH_COS}
    h, w = _image_size(variant, mesh.size)
    r = np.random.RandomState(0)
    content = r.rand(h, w, 3).astype(np.float32)
    style = r.rand(64, 64, 3).astype(np.float32)
    image = np.clip(content + 0.1 * r.randn(h, w, 3), 0, 1).astype(np.float32)
    cfg = StylizeConfig(size=(h, w), min_scale=max(h, w), iterations=(1,))
    dtype = torch.float64 if mesh.home.type == "cpu" else None
    out = []
    with _forced(variant):
        for m in (mesh, None):
            st = StyleTransfer(params, mean=mean, std=std, device=mesh.home, mesh=m,
                               compute_dtype=dtype)
            out.append(_evaluate(st, cfg, content, style, image))
    (t_sh, g_sh, route), (t_ref, g_ref, _) = out
    rel_terms = {k: abs(t_sh[k] - t_ref[k]) / max(abs(t_ref[k]), 1e-30) for k in t_ref}
    grad_rel = float((g_sh - g_ref).norm() / g_ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(g_sh.flatten(), g_ref.flatten(), dim=0))
    forms = dict(route)
    res = {"variant": variant, "shards": mesh.size, "size": [h, w],
           "terms": t_sh, "rel_terms": rel_terms, "grad_rel": grad_rel, "grad_cos": cos,
           "route": [list(p) for p in route]}
    want = _expected_forms(variant)
    wrong = {k: forms.get(k) for k, v in want.items() if forms.get(k) != v}
    if wrong:
        raise AssertionError(f"[{variant}] segments took other forms than {want}: {wrong}")
    if (max(rel_terms.values()) > tol["terms"] or grad_rel > tol["grad"]
            or cos < tol["cos"]):
        raise AssertionError(f"[{variant}] sharded objective departs from the unsharded one "
                             f"beyond {tol}: {res}")
    return res


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     variants: Sequence[str] = VARIANTS, tol=None):
    """Every variant of :data:`VARIANTS` on a mesh of ``n_devices`` devices:
    the first ones of ``devices`` (which may repeat one device), or of the
    visible CUDA devices. Returns the per-variant results; raises on the
    first that fails."""
    from style_transfer_tpu_torch.models.weights import random_fixture

    if devices is None:
        mesh = M.make_mesh(n_devices)
    else:
        if len(devices) < n_devices:
            raise ValueError(f"asked for {n_devices} devices, have {len(devices)}")
        mesh = M.make_mesh(devices=list(devices)[:n_devices])
    params, mean, std = random_fixture(0)
    return [run_variant(v, mesh, params, mean, std, tol) for v in variants]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="shards")
    p.add_argument("--cpu", action="store_true", help="N CPU shards")
    p.add_argument("--repeat", action="store_true", help="cuda:0 N times")
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args(argv)
    devices = ["cpu"] * args.n if args.cpu else (["cuda:0"] * args.n if args.repeat else None)
    for res in dryrun_multichip(args.n, devices, args.variants.split(",")):
        print(res, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
