#!/usr/bin/env python3
"""On-GPU check of the PyTorch port (style_transfer_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:

1. device — the card, its power limit (nvidia-smi), torch and CUDA versions;
2. build — compiles the hand-written kernels from ``style_transfer_tpu_torch/
   csrc`` with nvcc (sm_90a) and reports the seconds and the compiler's
   register and spill report;
3. kernel — each kernel wrapper at the shapes the 512 px main path gives it,
   and the single-conv wrappers at the shapes of the large-image path (the
   block-2 segment of the 256x4096 scale, the block-4 front of the 512x8192
   scale, conv5_1's ``gram_tail`` there, and a forced two-slice W-sliced
   single against the unsliced one), in bf16, against the plain PyTorch
   version run in fp32 on the same bf16-valued inputs: forward outputs and
   the input gradient for a random cotangent, relative Frobenius and max-abs
   errors; each error must be within its stated limit and at most 1.5x the
   plain version's own bf16 error plus 1e-3
   (``style_transfer_tpu_torch/ops/kernels/tolerances.py``); for each, the
   fwd+bwd device time per call (profiler, kernels only) and the median of
   20 CUDA-event-timed calls (which also counts host launch gaps). Block 1
   and TV also run once at the 512x8192 panorama's full size, the largest
   tensors of the port (the index-width check of ``csrc/common.cuh``);
4. segment forms — the fused pair against the pair of singles at the five
   two-conv segments of the 2048x2048 scale (effective width 2048, where
   the dispatch switches to singles): both times, and their agreement;
5. parity — the fused objective's loss terms and image gradient at a small
   size, kernels in bf16 on the card against the CPU's fp32 plain path;
6. stylize — ``StyleTransfer().stylize()`` on 512x512 inputs with the
   256->512 ladder: every kernel of that path must launch, the per-step loss
   must be finite, fall within each scale and follow the curve of a witness
   run — the same stylize on the plain path in fp32 (``use_fused=False``,
   the path the CPU tests hold to the JAX package) — and the output must be
   finite in [0, 1] with shape (512, 512, 3); the steady it/s and the peak
   device memory per scale are reported;
7. large — the same checks for a 512x8192 panorama over the 128x2048 ->
   256x4096 -> 512x8192 ladder, where every two-conv segment runs as
   singles and the last scale's conv5_1 as ``gram_tail``: the singles and
   ``gram_tail`` must launch and the conv pair must not.

Each stylize phase sets every launch count to 0 just before it runs and
reads them all just after. Then a ``{"kernels": [...]}`` summary line (each
kernel's launches from the phase whose path runs it), the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed phase raises: the
script exits nonzero and prints no ok line. Without a CUDA device it exits
with code 2 before doing anything else.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# Fused objective on the card (bf16 kernels through 13 convs) against the
# CPU's fp32 plain path at 96x96: measured 8.4e-3 on the loss terms, 2.3e-2
# relative error and cosine 0.99975 on the image gradient. Limits: 2e-2 on
# the terms, 5e-2 and 0.999 on the gradient.
TOL_TERMS = 2e-2
TOL_GRAD_REL = 5e-2
TOL_GRAD_COS = 0.999
# Stylize on the card: the per-step total loss of the kernel path against
# the witness run of the plain path in fp32, as the largest per-step
# relative deviation. Each step's loss is taken at a different iterate, and
# Adam's normalized updates turn small gradient differences near zero into
# whole-step pixel moves, so the curves drift apart as the run goes on.
# Measured at the 256->512 ladder, 20 steps per scale: 1.3e-2 (256 px) and
# 1.7e-3 (512 px); cuDNN's bf16 path: 7.3e-3 at both. Limit: 3e-2.
TOL_CURVE = 3e-2

# kernel -> (the TPU kernel it replaces, its CUDA sources, the stylize phase
# whose path runs it)
KERNEL_META = {
    "block1_packed": ("style_transfer_tpu/ops/pallas/block1_packed.py:634",
                      ["csrc/conv3x3.cu", "csrc/gram.cu"], "stylize"),
    "conv_pair": ("style_transfer_tpu/ops/pallas/conv_pair.py:395",
                  ["csrc/conv3x3.cu", "csrc/gram.cu"], "stylize"),
    "conv_gram": ("style_transfer_tpu/ops/pallas/conv_gram.py:178",
                  ["csrc/conv3x3.cu", "csrc/gram.cu"], "stylize"),
    "tv_loss": ("style_transfer_tpu/ops/pallas/epilogue.py:316", ["csrc/tv.cu"], "stylize"),
    "conv_single": ("style_transfer_tpu/ops/pallas/conv_single.py:250/:321",
                    ["csrc/conv3x3.cu", "csrc/gram.cu"], "large"),
    "gram_tail": ("style_transfer_tpu/ops/pallas/conv_single.py:250/:321",
                  ["csrc/conv3x3.cu", "csrc/gram.cu"], "large"),
}

# kernel -> its module's launch counter attribute
COUNTERS = {
    "block1_packed": ("block1", "launches"), "conv_pair": ("conv_pair", "launches"),
    "conv_gram": ("conv_gram", "launches"), "tv_loss": ("epilogue", "launches"),
    "conv_single": ("conv_single", "launches"), "gram_tail": ("conv_single", "gram_tail_launches"),
}


def _counters():
    import importlib

    return {name: getattr(importlib.import_module(f"style_transfer_tpu_torch.ops.kernels.{mod}"),
                          attr)
            for name, (mod, attr) in COUNTERS.items()}


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _max_abs(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def _wall_ms(torch, fn, reps: int, warmup: int = 3):
    """Per-call times from CUDA events around each call: device time plus
    any gap where the device waited for the host to launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _device_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time per call: the summed durations of the kernels (and
    copies) the profiler saw on the card, without host launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        raise RuntimeError("the profiler recorded no device time on the card")
    return us / reps / 1e3


def kernel_checks(torch, params):
    """Phase 3: every kernel wrapper at the shapes its path gives it, in bf16
    (TV in fp32), against its plain version run in fp32 on the same
    bf16-valued inputs, weights and cotangents. The plain version in bf16 is
    held against the same reference, for scale, and timed against the
    kernel. Returns per-kernel summaries (errors of every case; times of the
    cases on a stylize path)."""
    from style_transfer_tpu_torch.ops.kernels import block1 as B1
    from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
    from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
    from style_transfer_tpu_torch.ops.kernels import conv_single as CS
    from style_transfer_tpu_torch.ops.kernels import epilogue as EP
    from style_transfer_tpu_torch.ops.kernels.tolerances import (
        TOL_ACT, TOL_DX, TOL_GRAM, TOL_TV, within,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def bf(t):
        return t.to(bf16).float()  # bf16 values in fp32 storage

    def randn(*shape):
        return bf(torch.randn(shape, generator=gen, device=dev))

    def rand(*shape):
        return bf(torch.rand(shape, generator=gen, device=dev))

    def weights(*names):
        # the fixture's kernels; random biases, since the fixture's zero
        # biases would leave the bias-add rounding untested
        out = []
        for n in names:
            k = params[n]["kernel"].to(dev)
            out += [bf(k), bf(0.1 * torch.randn(k.shape[3], generator=gen, device=dev))]
        return out

    def pair(pool, gram, plain):
        fn = CP.conv_pair_plain if plain else CP.conv_pair
        return lambda x, *w: fn(x, *w, pool=pool, gram=gram)

    # (kernel, label, x, kernel fn, plain fn, weights, cotangents, output
    # tols, dtype, on a stylize path: its times go into the summary)
    hw = 512 * 512
    cases = [(
        "block1_packed", "1x512x512x3 -> pool1 + gram64", randn(1, 512, 512, 3),
        B1.block1_packed, B1.block1_plain, weights("conv1_1", "conv1_2"),
        (randn(1, 256, 256, 64), randn(64, 64) * (hw / 64)), (TOL_ACT, TOL_GRAM), bf16, True,
    )]
    pairs = [
        ("256x256 64->128 pool+gram", 256, 64, 128, True, True, ("conv2_1", "conv2_2")),
        ("128x128 128->256 gram", 128, 128, 256, False, True, ("conv3_1", "conv3_2")),
        ("128x128 256->256 pool", 128, 256, 256, True, False, ("conv3_3", "conv3_4")),
        ("64x64 256->512 gram", 64, 256, 512, False, True, ("conv4_1", "conv4_2")),
        ("64x64 512->512 pool", 64, 512, 512, True, False, ("conv4_3", "conv4_4")),
    ]
    for label, s, cin, cmid, pool, gram, names in pairs:
        so = s // 2 if pool else s
        cts, tols = (randn(1, so, so, cmid),), (TOL_ACT,)
        if gram:
            cts, tols = cts + (randn(cmid, cmid) * (s * s / cmid),), tols + (TOL_GRAM,)
        cases.append((
            "conv_pair", label, rand(1, s, s, cin), pair(pool, gram, False),
            pair(pool, gram, True), weights(*names), cts, tols, bf16, True,
        ))
    cases.append((
        "conv_gram", "32x32 512->512 gram", rand(1, 32, 32, 512),
        CG.conv_gram, CG.conv_gram_plain, weights("conv5_1"),
        (randn(512, 512) * (32 * 32 / 512),), (TOL_GRAM,), bf16, True,
    ))
    cases.append((
        "tv_loss", "1x512x512x3 fp32", rand(1, 512, 512, 3), EP.tv_loss, EP.tv_loss_plain,
        [], (torch.ones((), device=dev),), (TOL_TV,), torch.float32, True,
    ))

    def single_plain(pool, gram):
        return lambda x, k, b: CS.conv_single_plain(x, k, b, pool=pool, gram=gram)

    # the singles of the large-image path, in every epilogue combination the
    # dispatch uses: the block-2 segment of the 256x4096 scale (pool1 is
    # 128x2048) and the block-4 front of the 512x8192 scale (pool3 is 32x512)
    combos = [("gram", CS.single_gram, False, True), ("plain", CS.single_plain, False, False),
              ("pool", CS.single_pool, True, False)]
    for h, w, cin, cout, name in [(128, 2048, 64, 128, "conv2_1"), (32, 512, 256, 512, "conv4_1")]:
        for what, fn, pool, gram in combos:
            cts, tols = (randn(1, h // 2, w // 2, cout) if pool else randn(1, h, w, cout),), (TOL_ACT,)
            if gram:
                cts, tols = cts + (randn(cout, cout) * (h * w / cout),), tols + (TOL_GRAM,)
            cases.append((
                "conv_single", f"{h}x{w} {cin}->{cout} {what}", rand(1, h, w, cin), fn,
                single_plain(pool, gram), weights(name), cts, tols, bf16, True,
            ))
    cases.append((
        "gram_tail", "32x512 512->512 gram (conv5_1 of 512x8192)", rand(1, 32, 512, 512),
        CS.gram_tail, lambda x, k, b: CS.conv_single_plain(x, k, b, pool=False, gram=True)[1],
        weights("conv5_1"), (randn(512, 512) * (32 * 512 / 512),), (TOL_GRAM,), bf16, True,
    ))
    # the column window on the card: two W slices with halos, each Gram over
    # its owned columns, against the plain version (and, below, the unsliced
    # single)
    wide = CS.make_wide_single(pool=False, gram=True, slices=2)
    wide_x, wide_w = rand(1, 128, 2048, 64), weights("conv2_1")
    wide_cts = (randn(1, 128, 2048, 128), randn(128, 128) * (128 * 2048 / 128))
    cases.append((
        "conv_single", "128x2048 64->128 gram, W-sliced slices=2", wide_x, wide,
        single_plain(False, True), wide_w, wide_cts, (TOL_ACT, TOL_GRAM), bf16, False,
    ))
    # index width: block 1 and TV at the panorama's full size (block 1's
    # activations are 512*8192*64 = 268 M elements, its Gram 4.19 M rows)
    cases.append((
        "block1_packed", "1x512x8192x3 -> pool1 + gram64 (index width)", randn(1, 512, 8192, 3),
        B1.block1_packed, B1.block1_plain, weights("conv1_1", "conv1_2"),
        (randn(1, 256, 4096, 64), randn(64, 64) * (512 * 8192 / 64)), (TOL_ACT, TOL_GRAM), bf16,
        False,
    ))
    cases.append((
        "tv_loss", "1x512x8192x3 fp32 (index width)", rand(1, 512, 8192, 3), EP.tv_loss,
        EP.tv_loss_plain, [], (torch.ones((), device=dev),), (TOL_TV,), torch.float32, False,
    ))

    summary = {}
    for name, label, x, k_fn, p_fn, ws, cts, tols, dtype, on_path in cases:
        def run(fn, dt):
            xr = x.to(dt).requires_grad_(True)
            outs = fn(xr, *ws)
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads = [c.to(o.dtype) for c, o in zip(cts, outs)]
            (gx,) = torch.autograd.grad(outs, xr, grad_outputs=grads)
            return list(outs) + [gx]

        k_res, p_res = run(k_fn, dtype), run(p_fn, dtype)
        r_res = run(p_fn, torch.float32)
        torch.cuda.synchronize()
        whats = [f"out{i}" for i in range(len(tols))] + ["dx"]
        dx_tol = TOL_TV if name == "tv_loss" else TOL_DX
        errors = [
            {"what": w, "rel": _rel(k, r), "max_abs": _max_abs(k, r),
             "plain_bf16_rel": _rel(p, r), "tol": tol}
            for w, k, p, r, tol in zip(whats, k_res, p_res, r_res, list(tols) + [dx_tol])
        ]
        t_k, t_p = [], []
        for _ in range(2):  # kernel, plain, kernel, plain: in turns on one card
            t_k += _wall_ms(torch, lambda: run(k_fn, dtype), reps=10)
            t_p += _wall_ms(torch, lambda: run(p_fn, dtype), reps=10)
        wall, plain_wall = statistics.median(t_k), statistics.median(t_p)
        ms = _device_ms(torch, lambda: run(k_fn, dtype))
        plain_ms = _device_ms(torch, lambda: run(p_fn, dtype))
        emit({"phase": "kernel", "kernel": name, "case": label,
              "shape": list(x.shape), "errors": errors, "ms": ms, "plain_ms": plain_ms,
              "wall_ms_median20": wall, "plain_wall_ms_median20": plain_wall})
        bad = [e for e in errors if not within(e["rel"], e["plain_bf16_rel"], e["tol"])]
        if bad:
            raise AssertionError(f"{name} [{label}] disagrees with its plain version: {bad}")
        agg = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        agg["max_abs_err"] = max(agg["max_abs_err"], *(e["max_abs"] for e in errors))
        if on_path:
            agg["ms"] += ms
            agg["plain_ms"] += plain_ms

    # the W-sliced single against the unsliced single, both on the kernels
    def fwd_bwd(fn):
        xr = wide_x.to(bf16).requires_grad_(True)
        outs = fn(xr, *wide_w)
        (gx,) = torch.autograd.grad(outs, xr, grad_outputs=[c.to(o.dtype) for c, o in zip(wide_cts, outs)])
        return list(outs) + [gx]

    sliced, unsliced = fwd_bwd(wide), fwd_bwd(CS.single_gram)
    torch.cuda.synchronize()
    errors = [{"what": w, "rel": _rel(a, b), "max_abs": _max_abs(a, b), "tol": tol}
              for w, a, b, tol in zip(("out0", "out1", "dx"), sliced, unsliced,
                                      (TOL_ACT, TOL_GRAM, TOL_DX))]
    emit({"phase": "kernel", "kernel": "conv_single",
          "case": "W-sliced (slices=2) vs unsliced single, 128x2048 64->128 gram",
          "errors": errors})
    if any(e["rel"] > e["tol"] for e in errors):
        raise AssertionError(f"the W-sliced single disagrees with the unsliced one: {errors}")
    return summary


def segment_forms(torch, params):
    """Phase 4: the fused pair against the pair of singles at the two-conv
    segments of the 2048x2048 scale (effective width 2048, the first width
    the dispatch gives to singles), fwd+bwd in bf16 on the same inputs and
    cotangents: device ms (profiler) and event-timed medians, in turns on
    one card, and the two forms' agreement."""
    from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
    from style_transfer_tpu_torch.ops.kernels import conv_single as CS
    from style_transfer_tpu_torch.ops.kernels.tolerances import TOL_ACT, TOL_DX, TOL_GRAM

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    rows = []
    segments = [
        ("block2", 1024, 64, 128, True, True, ("conv2_1", "conv2_2")),
        ("block3_front", 512, 128, 256, False, True, ("conv3_1", "conv3_2")),
        ("block3_tail", 512, 256, 256, True, False, ("conv3_3", "conv3_4")),
        ("block4_front", 256, 256, 512, False, True, ("conv4_1", "conv4_2")),
        ("block4_tail", 256, 512, 512, True, False, ("conv4_3", "conv4_4")),
    ]
    for label, s, cin, cmid, pool, gram, names in segments:
        ws = []
        for n in names:
            k = params[n]["kernel"].to(dev)
            ws += [k.to(bf16).float(), (0.1 * torch.randn(k.shape[3], generator=gen, device=dev))]
        x = torch.rand(1, s, s, cin, generator=gen, device=dev).to(bf16)
        so = s // 2 if pool else s
        cts = [torch.randn(1, so, so, cmid, generator=gen, device=dev).to(bf16)]
        if gram:
            cts.append(torch.randn(cmid, cmid, generator=gen, device=dev) * (s * s / cmid))
        pair_fn = lambda xx, *w, p=pool, g=gram: CP.conv_pair(xx, *w, pool=p, gram=g)  # noqa: E731
        singles_fn = CS.make_pair_of_singles(pool=pool, gram=gram)

        def run(fn):
            xr = x.clone().requires_grad_(True)
            outs = fn(xr, *ws)
            outs = outs if isinstance(outs, tuple) else (outs,)
            (gx,) = torch.autograd.grad(outs, xr, grad_outputs=cts[: len(outs)])
            return list(outs) + [gx]

        a, b = run(pair_fn), run(singles_fn)
        torch.cuda.synchronize()
        tols = [TOL_ACT] + ([TOL_GRAM] if gram else []) + [TOL_DX]
        rels = [_rel(u, v) for u, v in zip(b, a)]
        t_p, t_s = [], []
        for _ in range(2):  # pair, singles, pair, singles
            t_p += _wall_ms(torch, lambda: run(pair_fn), reps=5)
            t_s += _wall_ms(torch, lambda: run(singles_fn), reps=5)
        row = {"phase": "segment_forms", "segment": label, "shape": list(x.shape), "cmid": cmid,
               "eff": s * cmid // 64, "pair_ms": _device_ms(torch, lambda: run(pair_fn), reps=3),
               "singles_ms": _device_ms(torch, lambda: run(singles_fn), reps=3),
               "pair_wall_ms_median10": statistics.median(t_p),
               "singles_wall_ms_median10": statistics.median(t_s),
               "singles_vs_pair_rel": rels, "tol": tols}
        emit(row)
        rows.append(row)
        if any(r > t for r, t in zip(rels, tols)):
            raise AssertionError(f"{label}: the pair of singles disagrees with the pair: {rels}")
    return rows


def parity_check(torch, params, mean, std):
    """Phase 5: the fused objective on the card (bf16 kernels) against the
    CPU's fp32 plain chain — the path the CPU tests hold against JAX."""
    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig

    r = np.random.RandomState(1)
    content = r.rand(96, 96, 3).astype(np.float32)
    style = r.rand(96, 96, 3).astype(np.float32)
    image_np = np.clip(content + 0.1 * r.randn(96, 96, 3), 0, 1).astype(np.float32)
    cfg = StylizeConfig(size=96)
    result = {}
    for dev in ("cuda", "cpu"):
        st = StyleTransfer(params, mean=mean, std=std, device=dev)
        c = torch.from_numpy(content)[None].to(dev)
        s = torch.from_numpy(style)[None].to(dev)
        c_t = st._capture_content(cfg, c)
        s_t = st._capture_style(cfg, s)
        image = torch.from_numpy(image_np)[None].to(dev).requires_grad_(True)
        loss, terms = st._build_objective(cfg)(image, c_t, s_t)
        (g,) = torch.autograd.grad(loss, image)
        result[dev] = ({k: float(v.detach()) for k, v in terms.items()}, g.detach().cpu())
    (tk, gk), (tp, gp) = result["cuda"], result["cpu"]
    rels = {k: abs(tk[k] - tp[k]) / max(abs(tp[k]), 1e-30) for k in tp}
    grad_rel = _rel(gk, gp)
    cos = float(torch.nn.functional.cosine_similarity(gk.flatten(), gp.flatten(), dim=0))
    ok = (all(v <= TOL_TERMS for v in rels.values())
          and grad_rel <= TOL_GRAD_REL and cos >= TOL_GRAD_COS)
    emit({"phase": "parity", "size": [96, 96], "gpu_terms": tk, "cpu_fp32_terms": tp,
          "term_rel": rels, "grad_rel": grad_rel, "grad_cos": cos,
          "tol": {"term_rel": TOL_TERMS, "grad_rel": TOL_GRAD_REL,
                  "grad_cos": TOL_GRAD_COS}})
    if not ok:
        raise AssertionError("fused objective on the card disagrees with the CPU fp32 path")


def _stylize(torch, st, content, style, cfg):
    """One ``stylize()`` call: (output, per-scale per-step total losses,
    MetricsRecorder summary with the scale sizes and each scale's peak
    device memory in MiB, seconds)."""
    from style_transfer_tpu_torch.utils.progress import MetricsRecorder

    rec = MetricsRecorder()
    curves, sizes, peak = {}, {}, {}

    def callback(ev):
        rec(ev)
        curves.setdefault(ev.scale_index, []).extend(float(v) for v in ev.losses["loss"])
        sizes[ev.scale_index] = list(ev.size)
        peak[ev.scale_index] = max(peak.get(ev.scale_index, 0.0),
                                   torch.cuda.max_memory_allocated() / 2**20)
        if ev.iteration == ev.total_iterations:  # the next scale's peak starts afresh
            torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = st.stylize(content, style, cfg, callback=callback)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, curves, dict(rec.summary(), sizes=sizes, peak_mib=peak), seconds


def stylize_check(torch, params, mean, std, *, phase, content, style, cfg, required, absent=()):
    """Phases 6 and 7: one path through the public API, with every launch
    count set to 0 just before it and read just after, against witness runs
    of the plain path in fp32 and in bf16. ``required`` kernels must have
    launched and ``absent`` ones must not. Returns the launch counts."""
    import dataclasses

    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer

    counters = _counters()
    st = StyleTransfer(params, mean=mean, std=std, device="cuda")
    for c in counters.values():
        c.n = 0
    out, curves, summary, seconds = _stylize(torch, st, content, style, cfg)
    launches = {k: c.n for k, c in counters.items()}

    # witnesses: the plain path in fp32 (cuDNN, TF32 off) and in bf16
    plain = dataclasses.replace(cfg, use_fused=False)
    st32 = StyleTransfer(params, mean=mean, std=std, device="cuda", compute_dtype=torch.float32)
    _, curves32, summary32, _ = _stylize(torch, st32, content, style, plain)
    _, curves16, summary16, _ = _stylize(torch, st, content, style, plain)

    def dev(a, b):  # largest per-step relative deviation of curve a from b
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    shape = (*cfg.end_size(content.shape[:2]), 3)
    emit({"phase": phase, "sizes": summary["sizes"], "seconds": seconds, "launches": launches,
          "its_per_sec_steady": summary["per_scale_its_per_sec"],
          "chunks_counted": summary["per_scale_chunks_counted"],
          "peak_mib": summary["peak_mib"],
          "plain_fp32_its_per_sec_steady": summary32["per_scale_its_per_sec"],
          "plain_bf16_its_per_sec_steady": summary16["per_scale_its_per_sec"],
          "plain_bf16_peak_mib": summary16["peak_mib"],
          "loss_per_step": curves, "plain_fp32_loss_per_step": curves32,
          "plain_bf16_loss_per_step": curves16,
          "dev_from_fp32": {k: dev(curves[k], curves32[k]) for k in curves},
          "plain_bf16_dev_from_fp32": {k: dev(curves16[k], curves32[k]) for k in curves},
          "tol_curve": TOL_CURVE,
          "out_shape": list(out.shape), "out_min": float(out.min()), "out_max": float(out.max())})
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched on the path: {missing}")
    stray = [k for k in absent if launches[k] != 0]
    if stray:
        raise AssertionError(f"{phase}: kernels launched off their path: {stray}")
    # "Falls within each scale", per step: the largest loss of the scale's
    # last chunk is below the largest of its first chunk. The first step is
    # no baseline: with init="content" the content term is zero there, and
    # Adam's first update (lr times the gradient's sign on every pixel)
    # raises the loss many times over before it falls, so at 256 px the
    # 20th step still lies above the first. The fp32 witness and the JAX
    # package's own curve do the same (PERF.md).
    n = cfg.chunk_size
    for k, v in curves.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{phase} scale {k}: loss not finite: {v}")
        if not max(v[-n:]) < max(v[:n]):
            raise AssertionError(f"{phase} scale {k}: loss not falling within the scale: {v}")
        if not dev(v, curves32[k]) <= TOL_CURVE:
            raise AssertionError(
                f"{phase} scale {k}: loss curve departs from the plain fp32 path's by "
                f"{dev(v, curves32[k])} > {TOL_CURVE}"
            )
    if out.shape != shape or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"{phase}: stylize output has the wrong shape or values")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from style_transfer_tpu_torch.models.weights import random_fixture
    from style_transfer_tpu_torch.ops.kernels import _build

    card = _nvidia_smi()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    report = [l.strip() for l in log.read_text().splitlines()
              if "registers" in l or "spill" in l] if log.is_file() else []
    emit({"phase": "build", "seconds": seconds, "ptxas": report})

    import numpy as np

    from style_transfer_tpu_torch import StylizeConfig

    params, mean, std = random_fixture(0)
    peak = {}

    def measured(phase, fn):  # runs a phase and keeps its peak device memory
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        peak[phase] = torch.cuda.max_memory_allocated() / 2**20
        return out

    summary = measured("kernel", lambda: kernel_checks(torch, params))
    measured("segment_forms", lambda: segment_forms(torch, params))
    measured("parity", lambda: parity_check(torch, params, mean, std))
    emit({"phase": "memory", "peak_mib": peak,
          "note": "the stylize phases print their peak per scale"})
    r = np.random.RandomState(0)
    launches = {"stylize": stylize_check(
        torch, params, mean, std, phase="stylize",
        content=r.rand(512, 512, 3).astype(np.float32),
        style=r.rand(512, 512, 3).astype(np.float32),
        cfg=StylizeConfig(size=512, min_scale=256, iterations=(20,), chunk_size=10),
        required=("block1_packed", "conv_pair", "conv_gram", "tv_loss"),
    )}
    r = np.random.RandomState(1)
    launches["large"] = stylize_check(
        torch, params, mean, std, phase="large",
        content=r.rand(512, 8192, 3).astype(np.float32),
        style=r.rand(512, 8192, 3).astype(np.float32),
        cfg=StylizeConfig(size=(512, 8192), min_scale=2048, iterations=(20,), chunk_size=10),
        required=("block1_packed", "conv_single", "gram_tail", "conv_gram", "tv_loss"),
        absent=("conv_pair",),
    )

    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "style_transfer_tpu_torch/" + sources[0],
         "sources": ["style_transfer_tpu_torch/" + s for s in sources],
         "replaces": replaces, "launches": launches[phase][name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (replaces, sources, phase) in KERNEL_META.items()
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
