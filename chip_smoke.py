#!/usr/bin/env python3
"""On-GPU check of the PyTorch port (style_transfer_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:

1. device — the card, its power limit (nvidia-smi), torch and CUDA versions;
2. build — compiles the hand-written kernels from ``style_transfer_tpu_torch/
   csrc`` with nvcc (sm_90a) and reports the seconds, the compiler's
   register and spill report, and from ``cuobjdump --dump-sass`` of the
   built library the count of tensor-core ops (``HMMA`` / ``wgmma``) in
   every conv, Gram and block-1 kernel, with the local-memory (spill) loads
   and stores between the first and the last of them; a conv, Gram product
   or block-1 kernel without any fails the phase (a toolkit without
   ``cuobjdump`` is reported and does not); ``block1_ptxas`` holds the
   registers and spill bytes of each instantiation of ``csrc/block1.cu``;
3. kernel — each kernel wrapper at the shapes the 512 px main path gives it,
   the single-conv wrappers at the shapes of the large-image path (the
   block-2 segment of the 256x4096 scale, the block-4 front of the 512x8192
   scale, conv5_1's ``gram_tail`` there, and a forced two-slice W-sliced
   single against the unsliced one), and the opt-in path's kernels at its
   1024 px shapes (``content_loss`` at conv4_2, ``style_loss`` at C = 64 and
   512, ``pallas_gram`` at the four materialized style layers with both
   forms of its backward, ``block1_full`` and ``block1_tail`` at 1024x1024
   with ``block1_packed`` timed beside), in bf16, against the plain PyTorch
   version run in fp32 on the same bf16-valued inputs: forward outputs and
   the input gradient for a random cotangent, relative Frobenius and max-abs
   errors; each error must be within its stated limit and at most 1.5x the
   plain version's own bf16 error plus 1e-3
   (``style_transfer_tpu_torch/ops/kernels/tolerances.py``); for each, the
   fwd+bwd device time per call (profiler, kernels only), the plain
   version's, the library yardstick's where one PyTorch call computes the
   same function (``F.conv2d`` with its backward-data, ``f.T @ f`` with the
   bf16 ``f @ S`` of its backward, ``F.mse_loss`` with its gradient), the
   bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over the peak rate, whichever is larger), and the median of
   20 CUDA-event-timed calls (which also counts host launch gaps). Block 1
   (all three forms) and TV also run once at the 512x8192 panorama's full
   size, the largest tensors of the port (the index-width check of
   ``csrc/common.cuh``). The three fused losses (``content_loss``,
   ``style_loss``, ``tv_loss``) are timed on tensors already in their dtype;
   the profiler counts the device launches of a call, which must be two (one
   forward, one backward kernel, no PyTorch op between); the gradient must
   have the bits of the plain backward and a second call the bits of the
   first; beside ``bound_ms``
   (the function as a whole) stands ``bound_two_pass_ms``, the bytes of the
   least schedule of two separate passes that autograd allows (the cotangent
   is unknown in the forward), and ``launch_pair_floor_ms``, what two empty
   launches take. Then the edge cases of
   ``ops/kernels/selfcheck.py`` (the conv and Gram launchers one option at a
   time, at sizes ragged against every tile, K = 3 and N = 3, Grams of 60
   to 262144 rows with and without a column window; ``block1_full`` and
   ``block1_tail`` at ragged sizes, an image smaller than one tile and one
   whose last block has a short run, with each cotangent alone and both;
   the col2im; the losses from 1 to 12.6 M elements, TV from a single pixel
   to 512x8192, with the cotangents 1, 0.7 and 0; each
   launched twice and compared bit for bit), the wrapper's tile table and
   its models of ``csrc/block1.cu`` and of the loss kernels' grids against
   the built library's, per conv shape of the 512 px and 2048 px scales the achieved
   TFLOP/s of forward and backward-data (profiler time), and
   ``block1_rates``: the block-1 forward, backward and col2im kernels apart
   at 1024x1024 and 512x8192 with their TFLOP/s, ``block1_packed`` and the
   plain col2im beside them, two launches bit for bit;
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
   ``gram_tail`` must launch and the conv pair must not;
8. fused_block1 — the same checks for ``StylizeConfig(fused_block1=True)``
   on 1024x1024 inputs with the 512->1024 ladder: ``block1_full`` and TV
   must launch, and none of the chain's kernels;
9. objective — ``ops.losses.objective_terms`` with all four hooks (the Gram
   kernel and the fused content, style and TV losses) under
   ``optim.make_step_fn`` / ``make_chunk_fn``, 20 Adam steps at 1024x1024,
   with block 1 as ``block1_full`` and as conv1_1 + ``block1_tail``: each
   loss curve against the hook-free plain fp32 objective, every kernel of
   the arm launched, and the step time with each hook on and off (at
   256x256 and 512x512 too for ``gram_matrix``'s dispatch), and the device
   launches of a step in each setting;
10. profile — one optimizer step of the default chain at 256x256, 512x512,
   2048x2048 and 512x8192: wall time, device time by kernel (profiler) and
   peak device memory;
11. ladder — ``stylize()`` of a 2048x2048 image over 256 -> 2048, 100 steps a
   scale, on the kernel chain and on the plain bf16 path, twice each in
   turns: steady it/s per scale, wall clock, peak memory and final loss.
12. lbfgs — L-BFGS (``optim.py``, ``linesearch.py``) through ``stylize()``:
   configuration 4 (memory 10, TV weight 8, ``stop_tol`` 1e-3 over 3
   chunks) at 1024 px over 256 -> 512 -> 1024, ``--steps`` a scale: the
   chain's four kernels must launch on every line-search trial and no
   opt-in or large-image kernel anywhere; per scale the steady it/s,
   objective evaluations and line-search steps a step, each step's learning
   rate and errors, host reads a step, peak memory and where early stop
   fired; the loss curves against the same run on the plain fp32 path
   (``tolerances.TOL_LBFGS_CURVE`` on the first chunk,
   ``TOL_LBFGS_CHUNK`` at every chunk's end, falling by chunk peaks). Then
   ten steps at 1024 px with ``linesearch_tol`` 1e-3 and 0 in turns, early
   stop at 256 px (the last event must carry ``done``), and a resume at
   1024 px from the first chunk's ``get_state()``, which must end on the
   uninterrupted run's bits.
13. cli — the command line, ``style_transfer_tpu_torch.cli.main`` in this
   process on seeded PNGs with ``--random-weights``: the five shipped
   configurations (``configs/*.toml``) at their own sizes with ``-i
   --steps``, configuration 5 on a 3840x2160 content (output shape, finite
   ``--metrics-out`` losses, falling by chunk peaks, the kernels of each
   path launched in each scale and no opt-in kernel; steady it/s, peak
   memory and launches per scale); ``--remat on`` against ``off`` at 1024
   px (bit-equal PNG and losses, each chain kernel's forward twice) and at
   4096x4096 on the chain and on the plain path, the stored path's peaks at
   2048^2 and 4096^2 on both with the linear fit behind
   ``api.REMAT_AUTO_PIXELS*``;
   a ``--resume`` from the middle of the last scale (bit-equal);
   ``--profile-dir`` (the trace names the chain's kernels),
   ``--fused-block1`` and ``--unfused`` (which kernels launch); ``--web``
   where aiohttp imports; ``python -m style_transfer_tpu_torch`` in a
   subprocess.
14. pipeline — the pipelined chunk loop of ``stylize()`` (``api.py``): the
   depth of CUDA's launch queue; no synchronizing CUDA call while an
   Adam chunk is queued on six routes (counted by file and line under
   ``torch.cuda.set_sync_debug_mode``), and an L-BFGS chunk's equal to its
   line-search reads; pipelined and sequential runs bit-equal over 256 ->
   1024 px (plain, EMA, early stop with two chunks queued) and L-BFGS over
   256 -> 512, images fetched in the callback included; a resume from a
   ``get_state()`` taken with two chunks queued; at 2048^2 in chunks of 50
   with the CLI's sinks, the device idle time between chunks from the
   profiler's trace (pipelined, under ``GAP_SHARE`` of a chunk's device
   time plus what the longest callback takes beyond a chunk; sequential,
   above it), each sink's and the callback's host time and the it/s both
   ways; configuration 2
   through ``cli.main`` with and without ``--no-pipeline``; the peak memory
   both ways at 2048^2 and 4096^2.
15. mesh — the spatial mesh (``style_transfer_tpu_torch/parallel``) on
   meshes that repeat the one card: at 2048x2048 with 2, 4 and 8 shards, on
   the natural route and with pairs and ``gram_tail`` forced, the loss terms
   and image gradient against the unsharded chain and the plain fp32
   witness, launches per kernel and per shard, an Adam step's wall and
   device ms and peak memory; the five sharded kernels alone at that
   scale's shapes with 8 shards against the unsharded kernels, with both
   times; 512x512 with 8 shards; configuration 5 through ``stylize()``
   (3840x2160 over its five scales, ``--steps`` a scale, 8 shards) against
   the unsharded run, with no synchronizing call in any Adam chunk;
   ``parallel.dryrun.dryrun_multichip(8, [cuda:0] * 8)``; and, where more
   than one card is visible, parts 1 and 3 over real devices (else a line
   says they did not run).

Each stylize phase, each arm of the objective phase and the lbfgs phase's
configuration-4 run, each ``cli.main`` run of the cli phase and each run of
the pipeline phase's bit-equality and gap parts and each objective evaluation
of the mesh phase set every launch count to 0 just before they run and read
them all just after. Then a
``{"kernels": [...]}`` summary line (eleven kernels, each with the launches
of the phase whose path runs it, forward and backward kernels alike, its
error, its time, the plain version's, the library call's and its bound, for
the losses the two-pass bound too; the five chain kernels that run per shard
also with ``mesh``: their launches in an 8-shard 2048^2 evaluation and their
sharded and unsharded times and bounds alone), the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed phase raises: the
script exits nonzero and prints no ok line. Without a CUDA device it exits
with code 2 before doing anything else.

``--phases a,b`` runs only the named phases (after device and build),
``--kernels a,b`` only the named kernels' cases of the kernel phase (``--phases
kernel --kernels content_loss,style_loss,tv_loss``: the losses with their
edge cases, a quarter of a minute after the build) and ``--steps N`` sets the
optimizer steps per scale of the stylize phases and of lbfgs's first part,
for comparing two trees in turns; the ``kernels`` line needs every phase and
every kernel.
"""

from __future__ import annotations

import contextlib
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
    "block1_full": ("style_transfer_tpu/ops/pallas/block1.py:555", ["csrc/block1.cu"],
                    "fused_block1"),
    "block1_tail": ("style_transfer_tpu/ops/pallas/block1.py:292", ["csrc/block1.cu"],
                    "objective_tail"),
    "pallas_gram": ("style_transfer_tpu/ops/pallas/gram.py:113", ["csrc/gram.cu"], "objective"),
    "content_loss": ("style_transfer_tpu/ops/pallas/epilogue.py:116", ["csrc/epilogue.cu"],
                     "objective"),
    "style_loss": ("style_transfer_tpu/ops/pallas/epilogue.py:174", ["csrc/epilogue.cu"],
                   "objective"),
}

# kernel -> its module's launch counter attribute
COUNTERS = {
    "block1_packed": ("block1", "launches"), "conv_pair": ("conv_pair", "launches"),
    "conv_gram": ("conv_gram", "launches"), "tv_loss": ("epilogue", "launches"),
    "conv_single": ("conv_single", "launches"), "gram_tail": ("conv_single", "gram_tail_launches"),
    "block1_full": ("block1", "full_launches"), "block1_tail": ("block1", "tail_launches"),
    "pallas_gram": ("gram", "launches"), "content_loss": ("epilogue", "content_launches"),
    "style_loss": ("epilogue", "style_launches"),
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


def _device_profile(torch, fn, reps: int = 5):
    """``(ms, launches, names)`` per call of ``fn``: the summed durations of
    the kernels (and copies) the profiler saw on the card, without host
    launch gaps, how many there were, and their names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):  # a trace now and then comes back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.time_range.elapsed_us() for e in events)
        if us > 0:
            return us / reps / 1e3, len(events) / reps, sorted({e.name for e in events})
    raise RuntimeError("the profiler recorded no device time on the card in three traces")


def _device_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time per call (see :func:`_device_profile`)."""
    return _device_profile(torch, fn, reps)[0]


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, 700 W):
# the yardsticks of each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def _bound(nbytes: float, flops: float, kind: str):
    """The least time the card could take, in ms, and what binds: the bytes
    the function must move (each input read once, each output written once)
    over the memory rate, or its operations over the peak rate for their
    type (bf16 on the tensor cores, fp32 outside them)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _conv_flops(h, w, *chain) -> float:
    """Forward plus backward-data of a chain of 3x3 convs ((cin, cout), ...)."""
    return sum(2 * 2.0 * h * w * 9 * cin * cout for cin, cout in chain)


def _gram_flops(m, c) -> float:
    """F^T F forward plus F S backward."""
    return 2 * 2.0 * m * c * c


def _cuobjdump():
    """Path of ``cuobjdump``: on PATH, in the toolkit, or Triton's copy."""
    import importlib.util
    import shutil
    from pathlib import Path

    candidates = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    return next((str(c) for c in candidates if c and Path(c).is_file()), None)


# kernels of csrc/conv3x3.cu, csrc/gram.cu and csrc/block1.cu whose products
# must run on the tensor cores (the Grams' reduce passes only add partials)
TENSOR_CORE_KERNELS = ("conv3x3_kernel", "gram_partial_kernel", "gram_fs_kernel",
                       "block1_fwd_kernel", "block1_bwd_kernel")


def tensor_core_report(lib_path):
    """Per conv, Gram and block-1 kernel of the built library: instantiations, their
    ``HMMA`` / ``wgmma`` ops and the local-memory loads and stores
    (register spills) between the first and the last of them, from
    ``cuobjdump --dump-sass``. Returns (report, names of product kernels
    without a tensor-core op); (None, []) without ``cuobjdump``."""
    import re

    tool = _cuobjdump()
    if tool is None:
        return None, []
    try:
        sass = subprocess.run([tool, "--dump-sass", str(lib_path)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    except (subprocess.SubprocessError, OSError):
        return None, []
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            op = re.search(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if op:
                cur.append(op.group(1))
    report = {}
    for name, ops in funcs.items():
        kernel = next((k for k in TENSOR_CORE_KERNELS + ("gram_reduce_kernel",)
                       if k in name and ("block1" in k) == ("block1" in name)), None)
        if kernel is None:
            continue
        mma = [i for i, op in enumerate(ops) if op.startswith("HMMA") or "GMMA" in op]
        local = sum(op.startswith(("LDL", "STL")) for op in ops[mma[0]:mma[-1]]) if mma else 0
        agg = report.setdefault(kernel, {"instantiations": 0, "mma": 0, "least_mma": None,
                                         "local_between_mma": 0})
        agg["instantiations"] += 1
        agg["mma"] += len(mma)
        agg["least_mma"] = len(mma) if agg["least_mma"] is None else min(agg["least_mma"], len(mma))
        agg["local_between_mma"] += local
        if local:  # which instantiation: its integer and boolean template arguments
            args = re.findall(r"L[ib](\d+)E", name)
            agg.setdefault("with_local", {})["<" + ",".join(args) + ">"] = local
    missing = [k for k in TENSOR_CORE_KERNELS if not report.get(k, {}).get("least_mma")]
    return report, missing


def ptxas_by_kernel(log_text, key):
    """Registers and spill bytes of every kernel whose mangled name holds
    ``key``, from the compilers' ``-Xptxas -v`` report: {name<template
    arguments>: {"registers": n, "spill_stores": b, "spill_loads": b}}."""
    import re

    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            cur = None
            if key in name:
                kernel = re.search(r"\d+(" + key + r"\w*?_kernel)", name)
                args = re.findall(r"L[ib](\d+)E", name)
                cur = out.setdefault((kernel.group(1) if kernel else name)
                                     + "<" + ",".join(args) + ">", {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


# edge-case families of ``ops/kernels/selfcheck.py`` that ``--kernels`` can select
EDGE_PREFIXES = {"content_loss": "sse-", "style_loss": "sse-", "tv_loss": "tv-"}


def edge_cases(torch, only=()):
    """The launchers of the tensor-core kernels and the fused losses at the
    edge cases of ``ops/kernels/selfcheck.py``, each launched twice; fails on
    any error beyond ``tolerances.within``, any ReLU-mask slip beyond bf16
    rounding of zero, any run-to-run difference and any loss gradient that
    has not the bits of its plain backward. ``only``: the cases of the named
    loss kernels alone."""
    from style_transfer_tpu_torch.ops.kernels import _build, selfcheck
    from style_transfer_tpu_torch.ops.kernels.tolerances import within

    dev = torch.device("cuda")
    if not selfcheck.tile_table_matches(_build.library()):
        raise AssertionError("the wrapper's conv tile table is not the built library's")
    if not selfcheck.block1_model_matches(_build.library()):
        raise AssertionError("the wrapper's model of csrc/block1.cu is not the built library's")
    if not selfcheck.loss_model_matches(_build.library()):
        raise AssertionError("the wrapper's model of the loss kernels' grids is not the built library's")
    worst, bad, unequal = {}, [], []
    names = selfcheck.all_cases()
    if only:
        names = [n for n in names
                 if n.startswith(tuple(EDGE_PREFIXES[k] for k in only if k in EDGE_PREFIXES))]
    for name in names:
        res = selfcheck.run_case(name, dev)
        torch.cuda.synchronize()
        for e in res["errors"]:
            kind = name.split("-")[0] + ":" + e["what"]
            w = worst.setdefault(kind, {"rel": 0.0, "plain_bf16_rel": 0.0, "tol": e["tol"]})
            if e["rel"] >= w["rel"]:
                w.update(rel=e["rel"], plain_bf16_rel=e["plain_bf16_rel"], case=name)
            if not within(e["rel"], e["plain_bf16_rel"], e["tol"]):
                bad.append((name, e))
        if res.get("mask_slip", 0.0) > res.get("mask_slip_limit", 0.0):
            bad.append((name, {"mask_slip": res["mask_slip"], "limit": res["mask_slip_limit"]}))
        if not (res["run_to_run_equal"] and res.get("backward_exact", True)):
            unequal.append(name)
    emit({"phase": "kernel", "kernel": "edge_cases", "cases": len(names), "worst": worst,
          "failed": [n for n, _ in bad], "run_to_run_unequal": unequal, "tile_table": "matches", "block1_model": "matches", "loss_model": "matches"})
    if bad or unequal:
        raise AssertionError(f"edge cases failed: {bad[:5]}; not bit-equal run to run or to the "
                             f"plain backward: {unequal[:5]}")


# (pools before it, cin, cout) of the chain's convs
VGG_CONVS = [("conv1_1", 0, 3, 64), ("conv1_2", 0, 64, 64), ("conv2_1", 1, 64, 128),
             ("conv2_2", 1, 128, 128), ("conv3_1", 2, 128, 256), ("conv3_2-4", 2, 256, 256),
             ("conv4_1", 3, 256, 512), ("conv4_2-4", 3, 512, 512), ("conv5_1", 4, 512, 512)]


def conv_rates(torch):
    """Achieved TFLOP/s of the bare forward and backward-data launches at
    every conv shape of the 512 px and 2048 px scales (profiler time), with
    ``F.conv2d`` forward beside them."""
    import torch.nn.functional as F

    from style_transfer_tpu_torch.ops.kernels import _build, _launch

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    count = _build.LaunchCount()
    for px in (512, 2048):
        rows = []
        for name, pools, cin, cout in VGG_CONVS:
            s = px >> pools
            x = torch.randn(s, s, cin, device=dev).to(bf16)
            w = (torch.randn(3, 3, cin, cout, device=dev) * (2.0 / (9 * cin)) ** 0.5).to(bf16)
            b = torch.zeros(cout, device=dev).to(bf16)
            dy = torch.randn(s, s, cout, device=dev).to(bf16)
            w_t = _launch.taps_transposed(w)
            xl = x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            flops = _conv_flops(s, s, (cin, cout)) / 2
            fwd = _device_ms(torch, lambda: _launch.conv3x3_fwd(x, w, b, y=True, count=count))
            bwd = _device_ms(torch, lambda: _launch.conv3x3_bwd_data(dy, w_t, hw=(s, s), count=count))
            lib = _device_ms(torch, lambda: F.conv2d(xl, wl, padding=1))
            rows.append({"conv": name, "shape": [s, s, cin, cout],
                         "tiles": [_launch.conv_tile(s, s, cout), _launch.conv_tile(s, s, cin)],
                         "fwd_ms": fwd, "fwd_tflops": flops / fwd / 1e9,
                         "bwd_ms": bwd, "bwd_tflops": flops / bwd / 1e9,
                         "library_fwd_ms": lib, "library_fwd_tflops": flops / lib / 1e9})
            del x, dy, xl
        emit({"phase": "kernel", "kernel": "conv_rates", "scale": px, "convs": rows,
              "fwd_ms_13_launches": sum(r["fwd_ms"] * (3 if "-4" in r["conv"] else 1) for r in rows),
              "bwd_ms_13_launches": sum(r["bwd_ms"] * (3 if "-4" in r["conv"] else 1) for r in rows)})
        torch.cuda.empty_cache()


def block1_rates(torch, params):
    """The one-pass block-1 kernels at 1024x1024 and 512x8192: device ms of
    the forward kernel, the backward kernel and ``block1_full``'s col2im
    (profiler, by kernel name), the achieved TFLOP/s of each against the
    operations the function needs (conv1_2's nine taps and the Gram or its
    term 64 deep, conv1_1 and its transpose 27 deep), ``block1_packed``'s
    fwd+bwd beside them, the plain col2im (nine slice-adds) beside the kernel,
    and two launches of each compared bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from style_transfer_tpu_torch.ops.kernels import _launch
    from style_transfer_tpu_torch.ops.kernels import block1 as B1

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    ws = []
    for n in ("conv1_1", "conv1_2"):
        k = params[n]["kernel"].to(dev)
        ws += [k, 0.1 * torch.randn(k.shape[3], generator=gen, device=dev)]

    def by_kernel(fn, reps=5):
        fn()
        for _ in range(3):  # a trace now and then comes back without device events
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            by = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    key = next((k for k in ("block1_fwd_kernel", "block1_bwd_kernel",
                                            "block1_col2im_kernel", "block1_gram_reduce_kernel")
                                if k in e.name), "other")
                    by[key] = by.get(key, 0.0) + e.time_range.elapsed_us() / reps / 1e3
            if by:
                return by
        raise RuntimeError("the profiler recorded no device time on the card in three traces")

    rows = []
    for h, w in [(1024, 1024), (512, 8192)]:
        x = torch.randn(1, h, w, 3, generator=gen, device=dev).to(bf16)
        r1 = torch.relu(torch.randn(1, h, w, 64, generator=gen, device=dev)).to(bf16)
        cts = [torch.randn(1, h // 2, w // 2, 64, generator=gen, device=dev).to(bf16),
               torch.randn(64, 64, generator=gen, device=dev) * (h * w / 64)]

        def run(fn, inp, weights):
            xr = inp.detach().requires_grad_(True)
            outs = fn(xr, *weights)
            (gx,) = torch.autograd.grad(outs, xr, grad_outputs=cts)
            return list(outs) + [gx]

        conv2 = 2.0 * h * w * 64 * (576 + 64)  # nine taps and the Gram (term), each way
        conv1 = 2.0 * h * w * 64 * 27
        row = {"size": [h, w]}
        for name, fn, inp, weights, extra in [("block1_tail", B1.block1_tail, r1, ws[2:], 0.0),
                                              ("block1_full", B1.block1_full, x, ws, conv1)]:
            a, b = run(fn, inp, weights), run(fn, inp, weights)
            torch.cuda.synchronize()
            by = by_kernel(lambda: run(fn, inp, weights))
            fwd, bwd = by["block1_fwd_kernel"], by["block1_bwd_kernel"]
            row[name] = {"ms": sum(by.values()), "ms_by_kernel": by,
                         "fwd_tflops": (conv2 + extra) / fwd / 1e9,
                         "bwd_tflops": (conv2 + extra) / bwd / 1e9,
                         "col2im_share": by.get("block1_col2im_kernel", 0.0) / sum(by.values()),
                         "run_to_run_equal": all(torch.equal(u, v) for u, v in zip(a, b))}
            del a, b
        packed = by_kernel(lambda: run(B1.block1_packed, x, ws))
        row["block1_packed"] = {"ms": sum(packed.values()),
                                "tflops": 2 * (conv2 + conv1) / sum(packed.values()) / 1e9}
        dpt = torch.randn(9, h, w, 3, generator=gen, device=dev).to(bf16)
        row["col2im_kernel_ms"] = _device_ms(torch, lambda: _launch.block1_col2im(dpt))
        row["col2im_plain_ms"] = _device_ms(torch, lambda: B1._col2im3(dpt).to(bf16))
        emit({"phase": "kernel", "kernel": "block1_rates", **row})
        rows.append(row)
        if not (row["block1_tail"]["run_to_run_equal"] and row["block1_full"]["run_to_run_equal"]):
            raise AssertionError(f"block 1 at {h}x{w} is not bit-equal from launch to launch")
        del x, r1, cts, dpt
        torch.cuda.empty_cache()
    return rows


def kernel_checks(torch, params, only=()):
    """Phase 3: every kernel wrapper at the shapes its path gives it, in bf16
    (TV, the fp32 content loss and the style loss in fp32), against its plain
    version run in fp32 on the same bf16-valued inputs, weights and
    cotangents. The plain version in the kernel's dtype is held against the
    same reference, for scale, and timed against the kernel; where one
    PyTorch call computes the same function (``F.conv2d`` and its
    backward-data for the conv kernels, ``f.T @ f`` and ``f @ S`` in bf16 for
    the Grams, ``F.mse_loss`` and its gradient for the content and style
    losses) it is timed too, forward and backward like the kernel, as a
    yardstick that the port never calls. Each case's bound (the
    least time the card could take) is computed from its tensors and its
    operation count. The three losses are timed on tensors already in their
    dtype (no cast of the harness inside the call): the profiler counts the
    launches of a call, which must be two; the gradient must have the bits
    of the plain backward and a second call the bits of the first; their
    bound is given twice, for the function as a
    whole and for the least schedule of two separate passes that autograd
    allows. ``only`` restricts the phase to the named kernels' cases (and, of
    the edge cases, to the losses'). Returns per-kernel summaries (errors of
    every case; times and bounds of the cases on a path that the script
    drives)."""

    import torch.nn.functional as F

    from style_transfer_tpu_torch.ops.kernels import _build, _launch
    from style_transfer_tpu_torch.ops.kernels import block1 as B1
    from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
    from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
    from style_transfer_tpu_torch.ops.kernels import conv_single as CS
    from style_transfer_tpu_torch.ops.kernels import epilogue as EP
    from style_transfer_tpu_torch.ops.kernels import gram as KG
    from style_transfer_tpu_torch.ops.kernels.tolerances import (
        TOL_ACT, TOL_DX, TOL_GRAM, TOL_LOSS, TOL_TV, within,
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

    def conv_library(h, w, *chain):
        """Forward and backward-data of the bare conv chain through
        ``F.conv2d`` (cuDNN, bf16, channels-last): the library yardstick."""
        xl = torch.randn(1, chain[0][0], h, w, device=dev, dtype=bf16).contiguous(
            memory_format=torch.channels_last)
        wts = [torch.randn(cout, cin, 3, 3, device=dev, dtype=bf16).contiguous(
            memory_format=torch.channels_last) for cin, cout in chain]
        gy = torch.randn(1, chain[-1][1], h, w, device=dev, dtype=bf16).contiguous(
            memory_format=torch.channels_last)

        def call():
            xr = xl.detach().requires_grad_(True)
            y = xr
            for wt in wts:
                y = F.conv2d(y, wt, padding=1)
            torch.autograd.grad(y, xr, grad_outputs=gy)

        return call

    def gram_library(f):
        """The Gram and its VJP product as two bf16 ``torch.matmul`` calls:
        ``f.T @ f`` forward, ``f @ S`` backward."""
        f2d = f.to(bf16).reshape(-1, f.shape[-1])
        sym = randn(f.shape[-1], f.shape[-1]).to(bf16)
        return lambda: (f2d.T @ f2d, f2d @ sym)

    def mse_library(f, target, dtype):
        """``F.mse_loss`` and its gradient to the first argument: the mean
        squared difference that both fused losses compute."""
        f, target = f.to(dtype), target.to(dtype)

        def call():
            fr = f.detach().requires_grad_(True)
            torch.autograd.grad(F.mse_loss(fr, target), fr)

        return call

    cases = []

    def add(kernel, label, x, k_fn, p_fn, ws, cts, tols, *, flops, dtype=bf16, on_path=True,
            kind="bf16", library=None, dx_tol=TOL_DX, cast_ws=False, extra=None, calls=None,
            loss=None):
        """One case: ``k_fn``/``p_fn`` (kernel wrapper, plain version) on x and
        ws, cotangents cts, per-output limits tols and the input gradient's
        dx_tol; ``on_path``: its times and bound go into the summary;
        ``flops``/``kind`` for the bound; ``library``: the yardstick call;
        ``cast_ws``: ws follow the run's dtype (a loss target); ``extra``:
        other wrappers timed on the same inputs; ``calls``: named calls timed
        as they are; ``loss``: for a fused loss, (its plain backward ``(x, ws,
        ct) -> gradient``, the passes over x of its least two-pass
        schedule)."""
        cases.append(dict(kernel=kernel, label=label, x=x, k_fn=k_fn, p_fn=p_fn, ws=ws, cts=cts,
                          tols=tols, flops=flops, dtype=dtype, on_path=on_path, kind=kind,
                          library=library, dx_tol=dx_tol, cast_ws=cast_ws, extra=extra or {},
                          calls=calls or {}, loss=loss))

    b1_chain = ((3, 64), (64, 64))
    hw = 512 * 512
    add("block1_packed", "1x512x512x3 -> pool1 + gram64", randn(1, 512, 512, 3),
        B1.block1_packed, B1.block1_plain, weights("conv1_1", "conv1_2"),
        (randn(1, 256, 256, 64), randn(64, 64) * (hw / 64)), (TOL_ACT, TOL_GRAM),
        flops=_conv_flops(512, 512, *b1_chain) + _gram_flops(hw, 64),
        library=conv_library(512, 512, *b1_chain))
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
        chain = ((cin, cmid), (cmid, cmid))
        add("conv_pair", label, rand(1, s, s, cin), pair(pool, gram, False),
            pair(pool, gram, True), weights(*names), cts, tols,
            flops=_conv_flops(s, s, *chain) + (_gram_flops(s * s, cmid) if gram else 0),
            library=conv_library(s, s, *chain))
    add("conv_gram", "32x32 512->512 gram", rand(1, 32, 32, 512),
        CG.conv_gram, CG.conv_gram_plain, weights("conv5_1"),
        (randn(512, 512) * (32 * 32 / 512),), (TOL_GRAM,),
        flops=_conv_flops(32, 32, (512, 512)) + _gram_flops(32 * 32, 512),
        library=conv_library(32, 32, (512, 512)))
    # a loss under autograd is two passes: TV reads the image, then reads it
    # again and writes the gradient (3 passes over x); the squared error
    # reads both operands, then reads them (or their difference) again and
    # writes the gradient (5)
    tv_case = (lambda x, ws, ct: EP.tv_backward_plain(x, ct), 3)
    sse_case = (lambda x, ws, ct: EP.sse_backward_plain(ct, x, ws[0]), 5)
    add("tv_loss", "1x512x512x3 fp32", rand(1, 512, 512, 3), EP.tv_loss, EP.tv_loss_plain,
        [], (torch.ones((), device=dev),), (TOL_TV,), flops=10.0 * 512 * 512 * 3,
        dtype=torch.float32, kind="fp32", dx_tol=TOL_TV, loss=tv_case)

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
            add("conv_single", f"{h}x{w} {cin}->{cout} {what}", rand(1, h, w, cin), fn,
                single_plain(pool, gram), weights(name), cts, tols,
                flops=_conv_flops(h, w, (cin, cout)) + (_gram_flops(h * w, cout) if gram else 0),
                library=conv_library(h, w, (cin, cout)))
    add("gram_tail", "32x512 512->512 gram (conv5_1 of 512x8192)", rand(1, 32, 512, 512),
        CS.gram_tail, lambda x, k, b: CS.conv_single_plain(x, k, b, pool=False, gram=True)[1],
        weights("conv5_1"), (randn(512, 512) * (32 * 512 / 512),), (TOL_GRAM,),
        flops=_conv_flops(32, 512, (512, 512)) + _gram_flops(32 * 512, 512),
        library=conv_library(32, 512, (512, 512)))
    # the column window on the card: two W slices with halos, each Gram over
    # its owned columns, against the plain version (and, below, the unsliced
    # single)
    wide = CS.make_wide_single(pool=False, gram=True, slices=2)
    wide_x, wide_w = rand(1, 128, 2048, 64), weights("conv2_1")
    wide_cts = (randn(1, 128, 2048, 128), randn(128, 128) * (128 * 2048 / 128))
    add("conv_single", "128x2048 64->128 gram, W-sliced slices=2", wide_x, wide,
        single_plain(False, True), wide_w, wide_cts, (TOL_ACT, TOL_GRAM), on_path=False,
        flops=_conv_flops(128, 2048, (64, 128)) + _gram_flops(128 * 2048, 128))
    # index width: block 1 and TV at the panorama's full size (block 1's
    # activations are 512*8192*64 = 268 M elements, its Gram 4.19 M rows)
    add("block1_packed", "1x512x8192x3 -> pool1 + gram64 (index width)", randn(1, 512, 8192, 3),
        B1.block1_packed, B1.block1_plain, weights("conv1_1", "conv1_2"),
        (randn(1, 256, 4096, 64), randn(64, 64) * (512 * 8192 / 64)), (TOL_ACT, TOL_GRAM),
        on_path=False, flops=_conv_flops(512, 8192, *b1_chain) + _gram_flops(512 * 8192, 64))
    add("tv_loss", "1x512x8192x3 fp32 (index width)", rand(1, 512, 8192, 3), EP.tv_loss,
        EP.tv_loss_plain, [], (torch.ones((), device=dev),), (TOL_TV,), on_path=False,
        flops=10.0 * 512 * 8192 * 3, dtype=torch.float32, kind="fp32", dx_tol=TOL_TV, loss=tv_case)

    # ---- the opt-in path's kernels, at the 1024 px shapes of its phases
    one = (torch.ones((), device=dev),)
    n42 = 128 * 128 * 512  # conv4_2 at 1024 px
    f42, t42 = rand(1, 128, 128, 512), rand(1, 128, 128, 512)
    add("content_loss", "conv4_2 at 1024 px: 16384x512 bf16", f42,
        EP.content_loss, EP.content_loss_plain, [t42], one, (TOL_LOSS,),
        flops=3.0 * n42, dx_tol=TOL_ACT, cast_ws=True, library=mse_library(f42, t42, bf16),
        loss=sse_case)
    f42, t42 = rand(1, 128, 128, 512), rand(1, 128, 128, 512)
    add("content_loss", "16384x512 fp32 input", f42,
        EP.content_loss, EP.content_loss_plain, [t42], one, (TOL_LOSS,),
        flops=3.0 * n42, dtype=torch.float32, kind="fp32", dx_tol=TOL_LOSS, on_path=False,
        library=mse_library(f42, t42, torch.float32), loss=sse_case)
    for c in (64, 512):
        g, g_t = randn(c, c), randn(c, c)
        add("style_loss", f"{c}x{c} fp32 Grams", g, EP.style_loss, EP.style_loss_plain,
            [g_t], one, (TOL_LOSS,), flops=3.0 * c * c, dtype=torch.float32, kind="fp32",
            dx_tol=TOL_LOSS, library=mse_library(g, g_t, torch.float32), loss=sse_case)

    def gram_backward_products(x, c):
        """The two ways to the Gram's VJP product F S: the fp32 matmul that
        ``pallas_gram`` takes, and the ``gram_fs`` kernel with S in bf16."""
        f = x.to(bf16).reshape(-1, c)
        sym = randn(c, c)
        s16 = sym.to(bf16)
        scratch = _build.LaunchCount()
        return {"bwd_matmul": lambda: (f.to(torch.float32) @ sym).to(bf16),
                "bwd_gram_fs": lambda: _launch.gram_fs(f, s16, count=scratch).to(bf16)}

    # the four style layers that materialize on the opt-in path at 1024 px,
    # and conv1_1's shape there (which that path gets from block 1 instead)
    # and, off the path, the shapes of the 512 px and 256 px scales of a
    # ladder, which decide gram_matrix's least activation size
    for s, c, px, on_path in [(512, 128, 1024, True), (256, 256, 1024, True),
                              (128, 512, 1024, True), (64, 512, 1024, True),
                              (1024, 64, 1024, False),
                              (512, 64, 512, False), (256, 128, 512, False), (128, 256, 512, False),
                              (256, 64, 256, False), (128, 128, 256, False), (64, 256, 256, False)]:
        x = rand(1, s, s, c)
        add("pallas_gram", f"{s * s}x{c} ({px} px)", x, KG.pallas_gram, KG.gram_plain, [],
            (randn(c, c) * (s * s / c),), (TOL_GRAM,), flops=_gram_flops(s * s, c),
            library=gram_library(x), dx_tol=TOL_ACT, on_path=on_path,
            calls=gram_backward_products(x, c))

    for h, w, on_path in [(1024, 1024, True), (512, 8192, False)]:
        note = "" if on_path else " (index width)"
        cts = (randn(1, h // 2, w // 2, 64), randn(64, 64) * (h * w / 64))
        full_w = weights("conv1_1", "conv1_2")
        add("block1_full", f"1x{h}x{w}x3 -> pool1 + gram64{note}", randn(1, h, w, 3),
            B1.block1_full, B1.block1_plain, full_w, cts, (TOL_ACT, TOL_GRAM),
            on_path=on_path, flops=_conv_flops(h, w, *b1_chain) + _gram_flops(h * w, 64),
            library=conv_library(h, w, *b1_chain), extra={"block1_packed": B1.block1_packed})
        add("block1_tail", f"r1 1x{h}x{w}x64 -> pool1 + gram64{note}", rand(1, h, w, 64),
            B1.block1_tail, B1.block1_tail_plain, weights("conv1_2"), cts, (TOL_ACT, TOL_GRAM),
            on_path=on_path, flops=_conv_flops(h, w, (64, 64)) + _gram_flops(h * w, 64),
            library=conv_library(h, w, (64, 64)))

    # what two launches cost on the card with no work in them: the floor of a
    # loss whose tensors are a few KB
    launch_pair_floor_ms = _device_ms(torch, lambda: (_launch.noop(), _launch.noop()))
    summary = {}
    for case in cases:
        if only and case["kernel"] not in only:
            continue
        name, label, x, ws, cts = (case[k] for k in ("kernel", "label", "x", "ws", "cts"))
        k_fn, p_fn, dtype, tols = (case[k] for k in ("k_fn", "p_fn", "dtype", "tols"))

        def run(fn, dt):
            xr = x.to(dt).requires_grad_(True)
            outs = fn(xr, *([a.to(dt) for a in ws] if case["cast_ws"] else ws))
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads = [c.to(o.dtype) for c, o in zip(cts, outs)]
            (gx,) = torch.autograd.grad(outs, xr, grad_outputs=grads)
            return list(outs) + [gx]

        k_res, p_res = run(k_fn, dtype), run(p_fn, dtype)
        r_res = run(p_fn, torch.float32)
        torch.cuda.synchronize()
        whats = [f"out{i}" for i in range(len(tols))] + ["dx"]
        errors = [
            {"what": w, "rel": _rel(k, r), "max_abs": _max_abs(k, r),
             "plain_bf16_rel": _rel(p, r), "tol": tol}
            for w, k, p, r, tol in zip(whats, k_res, p_res, r_res, list(tols) + [case["dx_tol"]])
        ]
        # the function as a whole: (x, weights, cotangents) -> (outputs, dx)
        nbytes = (_nbytes(*k_res, x.to(dtype), *([a.to(dtype) for a in ws] if case["cast_ws"] else ws))
                  + sum(_nbytes(c.to(o.dtype)) for c, o in zip(cts, k_res)))
        bound_ms, bound_by = _bound(nbytes, case["flops"], case["kind"])
        loss_row = {}
        if case["loss"]:
            backward_plain, passes = case["loss"]
            x_dt, ws_dt = x.to(dtype), [a.to(dtype) for a in ws]

            def call(fn=k_fn):  # nothing of the harness between the tensors and the wrapper
                xr = x_dt.detach().requires_grad_(True)
                out = fn(xr, *ws_dt)
                return out, torch.autograd.grad(out, xr, grad_outputs=cts[0])[0]

            first, second = call(), call()
            ms, launches_per_call, names = _device_profile(torch, call)
            two_pass = passes * _nbytes(x_dt)
            loss_row = {
                "launches_per_call": launches_per_call, "device_kernels": names,
                "ms_with_harness_casts": _device_ms(torch, lambda: run(k_fn, dtype)),
                "plain_ms_with_harness_casts": _device_ms(torch, lambda: run(p_fn, dtype)),
                "backward_bit_equal": torch.equal(first[1], backward_plain(x_dt, ws_dt, cts[0])),
                "run_to_run_equal": all(torch.equal(a, b) for a, b in zip(first, second)),
                "two_pass_bytes": two_pass,
                "bound_two_pass_ms": _bound(two_pass, case["flops"], case["kind"])[0],
                "launch_pair_floor_ms": launch_pair_floor_ms,
            }
            plain_ms = _device_ms(torch, lambda: call(p_fn))
            del first, second
        del p_res, r_res
        t_k, t_p = [], []
        for _ in range(2):  # kernel, plain, kernel, plain: in turns on one card
            t_k += _wall_ms(torch, lambda: run(k_fn, dtype), reps=10)
            t_p += _wall_ms(torch, lambda: run(p_fn, dtype), reps=10)
        wall, plain_wall = statistics.median(t_k), statistics.median(t_p)
        if not case["loss"]:
            ms = _device_ms(torch, lambda: run(k_fn, dtype))
            plain_ms = _device_ms(torch, lambda: run(p_fn, dtype))
        library_ms = _device_ms(torch, case["library"]) if case["library"] else None
        extra_ms = {what + "_ms": _device_ms(torch, lambda: run(fn, dtype))
                    for what, fn in case["extra"].items()}
        extra_ms.update({what + "_ms": _device_ms(torch, fn) for what, fn in case["calls"].items()})
        emit({"phase": "kernel", "kernel": name, "case": label,
              "shape": list(x.shape), "errors": errors, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes": nbytes, "flops": case["flops"], **extra_ms, **loss_row,
              "wall_ms_median20": wall, "plain_wall_ms_median20": plain_wall})
        bad = [e for e in errors if not within(e["rel"], e["plain_bf16_rel"], e["tol"])]
        if bad:
            raise AssertionError(f"{name} [{label}] disagrees with its plain version: {bad}")
        if loss_row and not (loss_row["backward_bit_equal"] and loss_row["run_to_run_equal"]
                             and loss_row["launches_per_call"] == 2):
            raise AssertionError(
                f"{name} [{label}]: the backward kernel must have the bits of its plain version, a "
                f"second call the bits of the first, and a call two launches: {loss_row}")
        agg = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "bound_two_pass_ms": None,
                                        "library_ms": None, "by": {}})
        agg["max_abs_err"] = max(agg["max_abs_err"], *(e["max_abs"] for e in errors))
        if case["on_path"]:
            agg["ms"] += ms
            agg["plain_ms"] += plain_ms
            agg["bound_ms"] += bound_ms
            agg["by"][bound_by] = agg["by"].get(bound_by, 0.0) + bound_ms
            if library_ms is not None:
                agg["library_ms"] = (agg["library_ms"] or 0.0) + library_ms
            if loss_row:
                agg["bound_two_pass_ms"] = ((agg["bound_two_pass_ms"] or 0.0)
                                            + loss_row["bound_two_pass_ms"])
        del k_res
        torch.cuda.empty_cache()
    for agg in summary.values():  # what binds most of the kernel's bound
        agg["bound_by"] = max(agg.pop("by").items(), key=lambda kv: kv[1])[0]

    if only:
        edge_cases(torch, only)
        return summary

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
    edge_cases(torch)
    conv_rates(torch)
    block1_rates(torch, params)
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


def _counted_stylize(torch, st, content, style, cfg):
    """:func:`_stylize` with every launch count set to 0 just before it and
    read just after: (output, curves, summary, seconds, launches)."""
    counters = _counters()
    for c in counters.values():
        c.n = 0
    out, curves, summary, seconds = _stylize(torch, st, content, style, cfg)
    return out, curves, summary, seconds, {k: c.n for k, c in counters.items()}


def stylize_check(torch, params, mean, std, *, phase, content, style, cfg, required, absent=()):
    """Phases 6 to 8: one path through the public API, with every launch
    count set to 0 just before it and read just after, against witness runs
    of the plain path in fp32 and in bf16. ``required`` kernels must have
    launched and ``absent`` ones must not. Returns the launch counts."""
    import dataclasses

    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer

    st = StyleTransfer(params, mean=mean, std=std, device="cuda")
    out, curves, summary, seconds, launches = _counted_stylize(torch, st, content, style, cfg)

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


def objective_check(torch, params, mean, std):
    """Phase 9: the library's own entry points — ``ops.losses.objective_terms``
    with all four hooks (the Gram kernel, the fused content, style and TV
    losses) under ``optim.make_step_fn`` / ``make_chunk_fn`` — for 20 Adam
    steps on a 1024x1024 image, twice: block 1 as ``block1_full``, and as the
    plain conv1_1 + ``block1_tail``. Each loss curve is held to the same
    objective with no hook and plain block 1 in fp32; the launch counts are
    set to 0 just before each arm and read just after, and every kernel of
    the arm must have launched. Then the step time with each hook on and off
    (block 1 as ``block1_full``; for the Gram at C = 64, which no kernel path
    materializes, block 1 plain), and at 256x256 and 512x512 the step time
    without the Gram kernel, with it by width alone and with ``gram_matrix``
    as it dispatches, in turns on one card: the wall time of ten
    steps and the device time of three (profiler), five rounds each. Returns
    the two arms' launch counts."""
    import numpy as np

    from style_transfer_tpu_torch.models import vgg
    from style_transfer_tpu_torch.ops import losses as L
    from style_transfer_tpu_torch.ops.kernels import block1 as B1
    from style_transfer_tpu_torch.ops.kernels import epilogue as EP
    from style_transfer_tpu_torch.ops.kernels import gram as KG
    from style_transfer_tpu_torch.optim import OptimizerSpec, make_chunk_fn, make_step_fn
    from style_transfer_tpu_torch.utils import imgio

    dev = torch.device("cuda")
    p = {n: {k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in lp.items()}
         for n, lp in params.items()}
    content_layers, style_layers = vgg.DEFAULT_CONTENT_LAYERS, vgg.DEFAULT_STYLE_LAYERS
    layers = tuple(dict.fromkeys(content_layers + style_layers))
    deeper = tuple(l for l in layers if l != "conv1_1")
    c_w = L.normalize_layer_weights(content_layers)
    s_w = L.normalize_layer_weights(style_layers)
    r = np.random.RandomState(3)
    content = torch.from_numpy(r.rand(1, 1024, 1024, 3).astype(np.float32)).to(dev)
    style = torch.from_numpy(r.rand(1, 1024, 1024, 3).astype(np.float32)).to(dev)
    b1w = [p["conv1_1"]["kernel"], p["conv1_1"]["bias"], p["conv1_2"]["kernel"], p["conv1_2"]["bias"]]

    def features(image, block1, dtype):
        """(feats, gram overrides): block 1 as a kernel ("full", "tail") and
        the deeper blocks plain, or everything plain."""
        x = imgio.preprocess(image, mean, std).to(dtype)
        if block1 == "plain":
            return vgg.extract_features(p, x, layers), None
        if block1 == "full":
            pool1, g1 = B1.block1_full(x, *b1w)
        else:
            r1 = vgg.extract_features(p, x, ("conv1_1",))["conv1_1"]
            pool1, g1 = B1.block1_tail(r1, *b1w[2:])
        return vgg.extract_features(p, pool1, deeper, start_block=2), {"conv1_1": g1}

    all_hooks = dict(gram_fn=KG.pallas_gram, content_loss_fn=EP.content_loss,
                     style_loss_fn=EP.style_loss, tv_loss_fn=EP.tv_loss)

    def make_objective(block1, dtype, hooks, images=(content, style)):
        gram_fn = hooks.get("gram_fn", L.gram_matrix)
        with torch.no_grad():
            c_t = {l: features(images[0], block1, dtype)[0][l] for l in content_layers}
            feats, over = features(images[1], block1, dtype)
            s_t = {l: (over or {}).get(l, None) for l in style_layers}
            s_t = {l: g if g is not None else gram_fn(feats[l]) for l, g in s_t.items()}

        def objective(image):
            feats, over = features(image, block1, dtype)
            terms = L.objective_terms(
                feats, gram_overrides=over, content_targets=c_t, style_targets=s_t,
                content_layer_weights=c_w, style_layer_weights=s_w, image=image,
                content_weight=1.0, style_weight=256.0, tv_weight=2.0, **hooks)
            return terms["loss"], terms

        return objective

    def curve(objective, steps=20, chunk=10):
        step, optimizer = make_step_fn(objective, OptimizerSpec())
        run_chunk = make_chunk_fn(step, chunk)
        image, state, out = content, optimizer.init(content), []
        for _ in range(steps // chunk):
            image, state, losses = run_chunk(image, state)
            out += [float(v) for v in losses["loss"].cpu()]
        return out

    witness = curve(make_objective("plain", torch.float32, {}))
    counters = _counters()
    launches, curves, devs = {}, {}, {}
    arms = {"objective": ("full", "block1_full"), "objective_tail": ("tail", "block1_tail")}
    for phase, (block1, kernel) in arms.items():
        objective = make_objective(block1, torch.bfloat16, all_hooks)  # capture is not counted
        for c in counters.values():
            c.n = 0
        curves[phase] = curve(objective)
        torch.cuda.synchronize()
        launches[phase] = {k: c.n for k, c in counters.items()}
        devs[phase] = max(abs(a - b) / abs(b) for a, b in zip(curves[phase], witness))
        required = (kernel, "pallas_gram", "content_loss", "style_loss", "tv_loss")
        missing = [k for k in required if launches[phase][k] == 0]
        stray = [k for k, n in launches[phase].items() if n and k not in required]
        if missing or stray:
            raise AssertionError(f"{phase}: never launched {missing}, launched off the path {stray}")

    # step time with each hook on and off, block 1 as block1_full; Gram widths
    # one at a time through gram_matrix's channel set
    def gram_only(*widths):
        def fn(feat):
            return KG.pallas_gram(feat) if feat.shape[-1] in widths else L.gram_matrix(feat)
        return fn

    variants = {
        "no_hook": {},
        "gram_128": {"gram_fn": gram_only(128)},
        "gram_256": {"gram_fn": gram_only(256)},
        "gram_512": {"gram_fn": gram_only(512)},
        "gram_all": {"gram_fn": KG.pallas_gram},
        "content": {"content_loss_fn": EP.content_loss},
        "style": {"style_loss_fn": EP.style_loss},
        "tv": {"tv_loss_fn": EP.tv_loss},
        "all_four": all_hooks,
    }
    steps = {k: make_step_fn(make_objective("full", torch.bfloat16, h), OptimizerSpec()) + (content,)
             for k, h in variants.items()}
    # C = 64 materializes only where no block-1 kernel runs: the all-plain
    # objective with and without the Gram kernel at that width
    for k, h in {"plain_block1_no_hook": {}, "plain_block1_gram_64": {"gram_fn": gram_only(64)}}.items():
        steps[k] = make_step_fn(make_objective("plain", torch.bfloat16, h), OptimizerSpec()) + (content,)
    # the smallest scale a default ladder runs, 256 px, where the step waits
    # on the host: the Gram kernel through gram_matrix's channel set on the
    # two routes that reach it (block1_full + plain blocks 2-5, and the
    # all-plain features that a configuration outside the chain's gates
    # takes), and 512 px: without the kernel, with it at every width of the
    # set whatever the size, and with gram_matrix as it dispatches
    by_width = {"gram_fn": gram_only(*KG.KERNEL_CHANNELS)}
    as_shipped = {"gram_fn": KG.gram_matrix}
    for px, block1 in [(256, "full"), (256, "plain"), (512, "full")]:
        small = (content[:, :px, :px].contiguous(), style[:, :px, :px].contiguous())
        name = f"{px}_plain_block1" if block1 == "plain" else str(px)
        for what, h in [("no_hook", {}), ("gram_by_width", by_width), ("gram_matrix", as_shipped)]:
            steps[f"{name}_{what}"] = make_step_fn(
                make_objective(block1, torch.bfloat16, h, small), OptimizerSpec()) + (small[0],)
    times, device, device_launches = {k: [] for k in steps}, {k: [] for k in steps}, {}
    for _ in range(5):  # every variant in turn, five rounds
        for k, (step, optimizer, start) in steps.items():
            carry = [start, optimizer.init(start)]

            def one_step():
                carry[0], carry[1], _ = step(carry[0], carry[1])

            for _ in range(2):
                one_step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                one_step()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / 10 * 1e3)
            ms, device_launches[k], _ = _device_profile(torch, one_step, reps=3)
            device[k].append(ms)
    emit({"phase": "objective", "size": [1024, 1024], "gram_channel_set": sorted(KG.KERNEL_CHANNELS),
          "gram_min_elements": KG.KERNEL_MIN_ELEMENTS,
          "launches": launches,
          "loss_per_step": curves, "plain_fp32_loss_per_step": witness,
          "dev_from_fp32": devs, "tol_curve": TOL_CURVE,
          "step_wall_ms_median5": {k: statistics.median(v) for k, v in times.items()},
          "step_device_ms_median5": {k: statistics.median(v) for k, v in device.items()},
          "step_device_launches": device_launches,
          "step_wall_ms_rounds": times, "step_device_ms_rounds": device})
    for phase, v in curves.items():
        if not np.isfinite(v).all() or not max(v[-10:]) < max(v[:10]):
            raise AssertionError(f"{phase}: loss not finite or not falling: {v}")
        if not devs[phase] <= TOL_CURVE:
            raise AssertionError(f"{phase}: loss curve departs from the plain fp32 objective's "
                                 f"by {devs[phase]} > {TOL_CURVE}")
    return launches


def step_profile(torch, params, mean, std):
    """Phase 10: where one optimizer step of the default chain spends its
    device time, by kernel, at four image sizes: ten steps on the host clock,
    five under the profiler."""
    import re

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.optim import OptimizerSpec, make_step_fn

    def group(name):
        m = re.search(r"conv3x3_kernel<.*>, (true|false), \(?[A-Za-z]*\)?(\d)>", name)
        if m:
            if m.group(1) == "true":
                return "conv_fwd"
            return "conv_bwd_copied_input" if m.group(2) == "0" else "conv_bwd_staged_input"
        for key in ("gram_partial_kernel", "gram_reduce_kernel", "gram_fs_kernel", "tv_",
                    "sse_kernel", "scale_cast_kernel"):
            if key in name:
                return key.rstrip("_")
        return "other"

    st = StyleTransfer(params, mean=mean, std=std, device="cuda")
    r = np.random.RandomState(5)
    for h, w in [(256, 256), (512, 512), (2048, 2048), (512, 8192)]:
        cfg = StylizeConfig(size=(h, w))
        content = torch.from_numpy(r.rand(1, h, w, 3).astype(np.float32)).cuda()
        style = torch.from_numpy(r.rand(1, h, w, 3).astype(np.float32)).cuda()
        c_t, s_t = st._capture_content(cfg, content), st._capture_style(cfg, style)
        objective = st._build_objective(cfg)
        step, optimizer = make_step_fn(lambda img: objective(img, c_t, s_t), OptimizerSpec())
        carry = [content, optimizer.init(content)]

        def one_step():
            carry[0], carry[1], _ = step(carry[0], carry[1])

        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(10):
            one_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        by, launches = {}, {}
        for _ in range(3):  # a trace now and then comes back without device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    one_step()
                torch.cuda.synchronize()
            by, launches = {}, {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    g = group(e.name)
                    by[g] = by.get(g, 0.0) + e.time_range.elapsed_us() / 5 / 1e3
                    launches[g] = launches.get(g, 0) + 1 / 5
            if by:
                break
        if not by:
            raise RuntimeError("the profiler recorded no device time on the card in three traces")
        device = sum(by.values())
        emit({"phase": "profile", "size": [h, w], "step_wall_ms": wall, "its_per_sec": 1e3 / wall,
              "step_device_ms": device, "device_busy": device / wall, "device_ms_by_kernel": by,
              "launches_per_step": launches, "peak_mib": peak})
        del content, style, c_t, s_t, carry
        torch.cuda.empty_cache()


def ladder(torch, params, mean, std):
    """Phase 11: the 2048 px ladder (256 -> 2048, 100 steps a scale) through
    ``stylize()``, on the kernel chain and on the plain bf16 path, in turns."""
    import dataclasses

    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig

    r = np.random.RandomState(4)
    content = r.rand(2048, 2048, 3).astype(np.float32)
    style = r.rand(2048, 2048, 3).astype(np.float32)
    st = StyleTransfer(params, mean=mean, std=std, device="cuda")
    cfg = StylizeConfig(size=2048, min_scale=256, iterations=(100,), chunk_size=10)
    runs = []
    for what, c in [("kernels", cfg), ("plain_bf16", dataclasses.replace(cfg, use_fused=False))] * 2:
        out, curves, summary, seconds = _stylize(torch, st, content, style, c)
        runs.append({"path": what, "seconds": seconds, "sizes": summary["sizes"],
                     "its_per_sec_steady": summary["per_scale_its_per_sec"],
                     "peak_mib": summary["peak_mib"], "final_loss": summary["final_loss"]})
        if out.shape != (2048, 2048, 3) or not np.isfinite(out).all():
            raise AssertionError(f"ladder ({what}): output has the wrong shape or values")
    emit({"phase": "ladder", "steps_per_scale": 100, "runs": runs})


LS_FIELDS = ("learning_rate", "decrease_error", "curvature_error", "num_linesearch_steps")


def _ls_info(state):
    """The line search's scalars of an L-BFGS state (device tensors)."""
    return {f: getattr(state.linesearch, f) for f in LS_FIELDS}


def _read_infos(torch, infos):
    """Per-step lists of each field, one host read a field."""
    return {f: torch.stack([i[f].float() for i in infos]).tolist() for f in LS_FIELDS}


class _LBFGSTrace:
    """While active, records every L-BFGS update of the port: the line
    search's scalars after it (device tensors, read after the run) and, for
    every line-search trial, how many times each kernel of ``required``
    launched during it. No host read of its own."""

    def __init__(self, required):
        self.required = required
        self.states, self.trials = [], []

    def __enter__(self):
        from style_transfer_tpu_torch import optim

        counters = _counters()
        self._real = real = optim.LBFGS.update
        trace = self

        def update(opt, grad, state, image, *, value, value_fn):
            def counted(x):
                before = {k: counters[k].n for k in trace.required}
                out = value_fn(x)
                trace.trials.append({k: counters[k].n - before[k] for k in trace.required})
                return out

            updates, new = real(opt, grad, state, image, value=value, value_fn=counted)
            trace.states.append((tuple(image.shape[1:3]), _ls_info(new)))
            return updates, new

        optim.LBFGS.update = update
        return self

    def __exit__(self, *exc):
        from style_transfer_tpu_torch import optim

        optim.LBFGS.update = self._real

    def per_scale(self, torch):
        """{size: per-step lists of learning_rate, decrease_error,
        curvature_error and num_linesearch_steps} (one host read a field)."""
        return {"x".join(map(str, size)): _read_infos(torch, [i for sz, i in self.states
                                                               if sz == size])
                for size in dict.fromkeys(sz for sz, _ in self.states)}


def lbfgs_check(torch, params, mean, std, steps):
    """Phase 12: L-BFGS (``optax.lbfgs`` with the zoom line search, ported
    in ``optim.py`` / ``linesearch.py``) through ``stylize()`` on the default
    kernel chain. Four parts:

    1. configuration 4 (``configs/config4_lbfgs_tv_1024.toml``: memory 10,
       TV weight 8, ``stop_tol`` 1e-3 over 3 chunks) at 1024 px over 256 ->
       512 -> 1024, ``steps`` a scale in chunks of 10, launch counts set to 0
       just before and read just after: the chain's kernels must launch on
       every line-search trial, no opt-in or large-image kernel anywhere; per
       scale the steady it/s, objective evaluations a step, line-search steps
       and each step's learning rate and errors, host reads a step, peak
       memory and where early stop fired; against a witness run on the plain
       path in fp32, every scale falling by chunk peaks, the loss at every
       chunk's end within ``tolerances.TOL_LBFGS_CHUNK`` and the first
       chunk's steps within ``TOL_LBFGS_CURVE`` (L-BFGS's curves part
       within a chunk where Adam's hold ``TOL_CURVE``: see tolerances.py);
    2. ten steps at 1024 px with ``linesearch_tol`` 1e-3 and 0, in turns,
       twice: line-search steps, errors and it/s of each, and the
       synchronizing CUDA calls of one more step
       (``torch.cuda.set_sync_debug_mode``);
    3. early stop at 256 px (``stop_tol=1``, ``stop_patience=1``): the run
       ends before its planned iterations and its last event has ``done``;
    4. resume at 1024 px: 30 steps in chunks of 10, and the same run resumed
       from ``get_state()`` of its first chunk, which must end on the same
       bits."""
    import dataclasses
    import warnings

    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch import linesearch
    from style_transfer_tpu_torch.ops.kernels.tolerances import TOL_LBFGS_CHUNK, TOL_LBFGS_CURVE
    from style_transfer_tpu_torch.optim import OptimizerSpec, make_step_fn

    chain = ("block1_packed", "conv_pair", "conv_gram", "tv_loss")
    absent = ("conv_single", "gram_tail", "block1_full", "block1_tail", "pallas_gram",
              "content_loss", "style_loss")
    r = np.random.RandomState(6)
    content = r.rand(1024, 1024, 3).astype(np.float32)
    style = r.rand(1024, 1024, 3).astype(np.float32)
    st = StyleTransfer(params, mean=mean, std=std, device="cuda")
    spec = OptimizerSpec("lbfgs", memory_size=10)
    chunk = 10
    cfg = StylizeConfig(size=1024, min_scale=256, optimizer=spec, tv_weight=8.0, stop_tol=1e-3,
                        stop_patience=3, iterations=(steps,) * 3, chunk_size=chunk)

    # 1. configuration 4
    reads0 = linesearch.host_reads.n
    with _LBFGSTrace(chain) as trace:
        out, curves, summary, seconds, launches = _counted_stylize(torch, st, content, style, cfg)
    host_reads = linesearch.host_reads.n - reads0
    per_scale = trace.per_scale(torch)
    st32 = StyleTransfer(params, mean=mean, std=std, device="cuda", compute_dtype=torch.float32)
    _, curves32, summary32, seconds32 = _stylize(
        torch, st32, content, style, dataclasses.replace(cfg, use_fused=False))
    n_steps = sum(len(v) for v in curves.values())
    trials = len(trace.trials)
    missed = [i for i, t in enumerate(trace.trials) if not all(t[k] > 0 for k in chain)]
    first_dev = max(abs(x - y) / abs(y) for x, y in zip(curves[0][:chunk], curves32[0][:chunk]))
    ends = lambda v: v[chunk - 1::chunk] + ([v[-1]] if len(v) % chunk else [])  # noqa: E731
    chunk_dev = {k: [abs(x - y) / abs(y) for x, y in zip(ends(curves[k]), ends(curves32[k]))]
                 for k in curves}
    scales = {}
    for k, (size, info) in enumerate(per_scale.items()):
        nls = info["num_linesearch_steps"]
        scales[size] = {
            "steps": len(curves[k]), "planned": steps,
            "host_reads_per_step": (sum(nls) + -(-len(nls) // chunk)) / len(nls),
            "early_stop_at": len(curves[k]) if len(curves[k]) < steps else None,
            "its_per_sec_steady": summary["per_scale_its_per_sec"].get(k),
            "evaluations_per_step": 1 + sum(nls) / len(nls),
            "linesearch_steps_mean": sum(nls) / len(nls), "linesearch_steps_max": max(nls),
            "learning_rate": info["learning_rate"], "decrease_error": info["decrease_error"],
            "curvature_error": info["curvature_error"],
            "peak_mib": summary["peak_mib"].get(k),
            "plain_fp32_its_per_sec_steady": summary32["per_scale_its_per_sec"].get(k),
            "final_loss": curves[k][-1], "plain_fp32_final_loss": curves32[k][-1],
        }
    result = {
        "phase": "lbfgs", "part": "config4_1024", "sizes": summary["sizes"], "seconds": seconds,
        "plain_fp32_seconds": seconds32, "launches": launches, "linesearch_trials": trials,
        "trials_without_every_chain_kernel": len(missed), "scales": scales,
        "host_reads_per_step": (host_reads + n_steps / chunk) / n_steps,
        "linesearch_host_reads": host_reads,
        "first_chunk_dev_from_fp32": first_dev, "tol_curve": TOL_LBFGS_CURVE,
        "chunk_end_dev_from_fp32": chunk_dev, "tol_chunk": TOL_LBFGS_CHUNK,
        "loss_per_step": curves, "plain_fp32_loss_per_step": curves32,
        "out_shape": list(out.shape), "out_min": float(out.min()), "out_max": float(out.max()),
    }
    emit(result)
    if missed:
        raise AssertionError(f"lbfgs: line-search trials without every chain kernel: {missed[:5]}")
    if host_reads != trials:
        raise AssertionError(f"lbfgs: {host_reads} line-search host reads for {trials} trials")
    never = [k for k in chain if launches[k] == 0]
    stray = [k for k in absent if launches[k] != 0]
    if never or stray:
        raise AssertionError(f"lbfgs: chain kernels never launched {never}, off-path kernels "
                             f"launched {stray}")
    for k, v in curves.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"lbfgs scale {k}: loss not finite: {v}")
        if len(v) > chunk and not max(v[-chunk:]) < max(v[:chunk]):
            raise AssertionError(f"lbfgs scale {k}: loss not falling within the scale: {v}")
        if not max(chunk_dev[k]) <= TOL_LBFGS_CHUNK:
            raise AssertionError(f"lbfgs scale {k}: chunk-end losses {chunk_dev[k]} from the fp32 "
                                 f"witness's > {TOL_LBFGS_CHUNK}")
    if not first_dev <= TOL_LBFGS_CURVE:
        raise AssertionError(f"lbfgs: first chunk departs from the fp32 path by {first_dev}")
    if out.shape != (1024, 1024, 3) or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("lbfgs: stylize output has the wrong shape or values")

    # 2. the line-search tolerance at 1024 px
    one = dataclasses.replace(cfg, size=1024, min_scale=1024)
    c = torch.from_numpy(content)[None].cuda()
    s = torch.from_numpy(style)[None].cuda()
    objective = st._build_objective(one)
    c_t, s_t = st._capture_content(one, c), st._capture_style(one, s)
    tols = {}
    for tol in (1e-3, 0.0, 1e-3, 0.0):
        step, opt = make_step_fn(lambda im: objective(im, c_t, s_t),
                                 dataclasses.replace(spec, linesearch_tol=tol))
        image, state, infos = c, opt.init(c), []
        reads0 = linesearch.host_reads.n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            image, state, _ = step(image, state)
            infos.append(_ls_info(state))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reads = linesearch.host_reads.n - reads0
        with warnings.catch_warnings(record=True) as caught:  # every synchronizing call of a step
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(image, state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        info = _read_infos(torch, infos)
        nls = info["num_linesearch_steps"]
        tols.setdefault(str(tol), []).append(dict(
            info, its_per_sec=10 / wall, linesearch_steps_mean=sum(nls) / len(nls),
            host_reads=reads, syncs_in_one_more_step=syncs,
            final_loss=float(state.linesearch.value)))
    emit({"phase": "lbfgs", "part": "linesearch_tol_1024", "steps": 10, "runs_in_turns": tols})
    del c, s, c_t, s_t, objective
    torch.cuda.empty_cache()

    # 3. early stop at 256 px
    small = r.rand(256, 256, 3).astype(np.float32)
    events = []
    early = StylizeConfig(size=256, min_scale=256, optimizer=spec, tv_weight=8.0, stop_tol=1.0,
                          stop_patience=1, iterations=(5 * chunk,), chunk_size=chunk)
    st.stylize(small, small[::-1].copy(), early, callback=events.append)
    emit({"phase": "lbfgs", "part": "early_stop_256", "planned": 5 * chunk,
          "events": [[e.iteration, e.done] for e in events]})
    if not (events[-1].iteration < 5 * chunk and events[-1].done):
        raise AssertionError("lbfgs: early stop did not end the run with a done event")

    # 4. resume on the card
    again = StylizeConfig(size=1024, min_scale=1024, optimizer=spec, tv_weight=8.0,
                          iterations=(3 * chunk,), chunk_size=chunk)
    saved = []
    full = st.stylize(content, style, again,
                      callback=lambda ev: saved.append(ev.get_state()) if not saved else None)
    resumed = st.stylize(content, style, again, resume_state=saved[0])
    equal = bool(np.array_equal(full, resumed))
    emit({"phase": "lbfgs", "part": "resume_1024", "resumed_from_iteration": int(saved[0]["iteration"]),
          "bit_equal": equal, "max_abs_diff": float(np.abs(full - resumed).max())})
    if not equal:
        raise AssertionError("lbfgs: the resumed run does not end on the uninterrupted run's bits")
    return launches


# The cli phase: the kernels each shipped configuration's path must launch,
# and those it must not, read from the dispatch (api._chain_features,
# ops/kernels/dispatch.py): every configuration runs the default chain on
# even extents, configuration 3 requests no conv5_1 (no conv_gram), and
# configuration 5's 3840-wide scale (effective width >= 2048) runs every
# two-conv segment as singles while its conv5_1 (effective width 1920) stays
# on conv_gram; its smaller 16:9 scales reach odd pool boundaries and run
# the rest of the VGG plain, as the reference does off its TPU grid, and
# ``gram_matrix`` sends the Grams of those materialized activations to the
# Gram kernel (``pallas_gram``, every width in ``gram.KERNEL_CHANNELS``).
CLI_CHAIN = ("block1_packed", "conv_pair", "conv_gram", "tv_loss")
CLI_OPT_IN = ("block1_full", "block1_tail", "pallas_gram", "content_loss", "style_loss")
CLI_CONFIGS = {
    "config1_gatys_512_adam": ((512, 512), 1, CLI_CHAIN, ("conv_single", "gram_tail")),
    "config2_multiscale_1024": ((1024, 1024), 1, CLI_CHAIN, ("conv_single", "gram_tail")),
    "config3_multistyle_blend": ((512, 512), 2, ("block1_packed", "conv_pair", "tv_loss"),
                                 ("conv_gram", "conv_single", "gram_tail")),
    "config4_lbfgs_tv_1024": ((1024, 1024), 1, CLI_CHAIN, ("conv_single", "gram_tail")),
    "config5_4k_sharded": ((2160, 3840), 1, CLI_CHAIN + ("conv_single", "pallas_gram"),
                           ("gram_tail",)),
}
#: Share of the card's 80 GB at which the auto-remat thresholds are placed
#: (api.REMAT_AUTO_PIXELS*): the rest is left to the caching allocator's
#: fragmentation and the CUDA context.
REMAT_SHARE = 0.75
CARD_BYTES = 80e9


class _ObservedStylize:
    """Wraps ``StyleTransfer.stylize`` so that each progress event of a run
    made through ``cli.main`` also records, before the CLI's own sinks see
    it, the per-step losses, the launch counts so far and the peak device
    memory of its scale (reset when a scale ends): the per-scale numbers
    the CLI's ``--metrics-out`` does not carry."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from style_transfer_tpu_torch import api

        self.api, self.real = api, api.StyleTransfer.stylize
        observer = self

        def stylize(st, content, styles, config=None, *, callback=None, **kw):
            counters = _counters()

            def observe(ev):
                torch = observer.torch
                k = ev.scale_index
                observer.curves.setdefault(k, []).extend(float(v) for v in ev.losses["loss"])
                observer.sizes[k] = list(ev.size)
                observer.cumulative[k] = {n: c.n for n, c in counters.items()}
                observer.peak[k] = max(observer.peak.get(k, 0.0),
                                       torch.cuda.max_memory_allocated() / 2**20)
                if ev.iteration == ev.total_iterations:  # the next scale's peak starts afresh
                    torch.cuda.reset_peak_memory_stats()
                callback(ev)

            return observer.real(st, content, styles, config, callback=observe, **kw)

        self.curves, self.sizes, self.cumulative, self.peak = {}, {}, {}, {}
        api.StyleTransfer.stylize = stylize
        return self

    def __exit__(self, *exc):
        self.api.StyleTransfer.stylize = self.real

    def per_scale_launches(self):
        out, before = {}, {}
        for k in sorted(self.cumulative):
            out[k] = {n: v - before.get(n, 0) for n, v in self.cumulative[k].items()}
            before = self.cumulative[k]
        return out


class _ForwardSpies:
    """Counts each chain kernel wrapper's calls made with autograd on: the
    optimizer's forwards and, under remat, the checkpoints' recomputes
    (captures run under ``no_grad``)."""

    WRAPPERS = (("block1", "block1_packed"), ("block2", "block2_fused"),
                ("conv_pair", "pair_gram"), ("conv_pair", "pair_pool"),
                ("conv_gram", "conv_gram"), ("conv_single", "gram_tail"))

    def __init__(self, torch):
        self.torch = torch

    def _spy(self, name, fn):
        def wrapped(*args):
            if self.torch.is_grad_enabled():
                self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args)
        return wrapped

    def __enter__(self):
        import importlib

        self.calls, self.saved = {}, []
        for mod_name, attr in self.WRAPPERS:
            mod = importlib.import_module(f"style_transfer_tpu_torch.ops.kernels.{mod_name}")
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, self._spy(attr, getattr(mod, attr)))
        cs = importlib.import_module("style_transfer_tpu_torch.ops.kernels.conv_single")
        make = cs.make_pair_of_singles
        self.saved.append((cs, "make_pair_of_singles", make))
        cs.make_pair_of_singles = lambda **kw: self._spy(
            f"singles_pool{int(kw['pool'])}_gram{int(kw['gram'])}", make(**kw))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_run(torch, argv, metrics_path=None, spies=False):
    """One ``style_transfer_tpu_torch.cli.main(argv)`` in this process, with
    every launch count set to 0 just before it and read just after. Returns
    the rc, seconds, the launches (all and per scale), per-scale peak MiB,
    per-step losses and sizes, the ``--metrics-out`` file, and with
    ``spies`` the chain wrappers' forward calls."""
    import contextlib

    from style_transfer_tpu_torch import cli

    if metrics_path is not None:
        argv = argv + ["--metrics-out", metrics_path]
    counters = _counters()
    for c in counters.values():
        c.n = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _ObservedStylize(torch) as obs, \
            (_ForwardSpies(torch) if spies else contextlib.nullcontext()) as spy:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    run = {"rc": rc, "seconds": seconds, "launches": {k: c.n for k, c in counters.items()},
           "launches_per_scale": obs.per_scale_launches(), "peak_mib": obs.peak,
           "curves": obs.curves, "sizes": obs.sizes,
           "forward_calls": dict(spy.calls) if spies else None}
    if rc != 0:
        raise AssertionError(f"cli: main({argv}) returned {rc}")
    if metrics_path is not None:
        with open(metrics_path) as f:
            run["metrics"] = json.load(f)
    return run


def _falls_by_chunk_peaks(curve, chunk):
    return max(curve[-chunk:]) < max(curve[:chunk])


def _png(path):
    import numpy as np

    from style_transfer_tpu_torch.utils import imgio

    return imgio.load_image(path, dtype=np.uint8)


class _CliInputs:
    """Seeded PNG inputs in a temporary directory, and the flags every run
    of the cli phase shares."""

    def __init__(self, tmp, sizes):
        import numpy as np

        from style_transfer_tpu_torch.utils import imgio

        r = np.random.RandomState(13)
        self.tmp, self.content = tmp, {}
        for hw in sorted(sizes):
            self.content[hw] = f"{tmp}/content_{hw[0]}x{hw[1]}.png"
            imgio.save_image(r.rand(*hw, 3).astype(np.float32), self.content[hw])
        self.styles = [f"{tmp}/style{i}.png" for i in range(2)]
        for path in self.styles:
            imgio.save_image(r.rand(512, 512, 3).astype(np.float32), path)
        self.common = ["--random-weights", "--chunk-size", "10", "--print-every", "100000"]

    @staticmethod
    def conf(name):
        from pathlib import Path

        return ["--config", str(Path(__file__).resolve().parent / "configs" / f"{name}.toml")]


def cli_configs(torch, io, steps):
    """The five shipped configurations through ``cli.main`` (see
    :func:`cli_check`, part 1)."""
    import numpy as np

    chunk = 10
    for name, (hw, n_styles, required, absent) in CLI_CONFIGS.items():
        out = f"{io.tmp}/{name}.png"
        run = _cli_run(torch, [io.content[hw], *io.styles[:n_styles], "-o", out, "-i", str(steps)]
                       + io.conf(name) + io.common, metrics_path=f"{io.tmp}/{name}.json")
        img = _png(out)
        losses = [rec["loss"] for rec in run["metrics"]["records"]]
        emit({"phase": "cli", "part": name, "sizes": run["sizes"], "seconds": run["seconds"],
              "its_per_sec_steady": run["metrics"]["summary"]["per_scale_its_per_sec"],
              "peak_mib": run["peak_mib"], "launches": run["launches"],
              "launches_per_scale": run["launches_per_scale"], "metrics_losses": losses,
              "out_shape": list(img.shape)})
        if img.shape != (*hw, 3):
            raise AssertionError(f"cli {name}: output shape {img.shape}, expected {hw}")
        if not losses or not np.isfinite(losses).all():
            raise AssertionError(f"cli {name}: --metrics-out losses not finite: {losses}")
        for k, v in run["curves"].items():
            if not np.isfinite(v).all() or not _falls_by_chunk_peaks(v, chunk):
                raise AssertionError(f"cli {name} scale {k}: loss not falling: {v}")
        missing = [k for k in required if run["launches"][k] == 0]
        stray = [k for k in absent + CLI_OPT_IN if k not in required and run["launches"][k] != 0]
        if missing or stray:
            raise AssertionError(f"cli {name}: never launched {missing}, stray {stray}")
        if name != "config5_4k_sharded":
            for k, counts in run["launches_per_scale"].items():
                if any(counts[n] == 0 for n in required):
                    raise AssertionError(f"cli {name}: scale {k} missed a kernel: {counts}")
        else:
            last = run["launches_per_scale"][max(run["launches_per_scale"])]
            if last["conv_pair"] != 0 or last["conv_single"] == 0:
                raise AssertionError(f"cli {name}: the 3840 scale is not on singles: {last}")


def cli_remat(torch, io, steps, sides=(2048, 4096)):
    """``--remat on`` against ``off`` (see :func:`cli_check`, part 2)."""
    import numpy as np

    from style_transfer_tpu_torch import api

    c1024 = io.content[(1024, 1024)]
    base = [c1024, io.styles[0], "-i", str(steps)] + io.conf("config2_multiscale_1024") + io.common
    runs = {}
    for mode in ("on", "off"):
        out = f"{io.tmp}/remat_{mode}.png"
        runs[mode] = _cli_run(torch, base + ["--remat", mode, "-o", out],
                              metrics_path=f"{io.tmp}/remat_{mode}.json", spies=True)
        runs[mode]["png"] = _png(out)
    on, off = runs["on"], runs["off"]
    equal_png = bool(np.array_equal(on["png"], off["png"]))
    equal_losses = bool(on["metrics"]["records"]
                        and [x["loss"] for x in on["metrics"]["records"]]
                        == [x["loss"] for x in off["metrics"]["records"]]
                        and on["curves"] == off["curves"])
    calls = {k: (off["forward_calls"].get(k), v) for k, v in on["forward_calls"].items()}
    emit({"phase": "cli", "part": "remat_1024", "png_bit_equal": equal_png,
          "losses_bit_equal": equal_losses, "forward_calls_off_on": calls,
          "launches_on": on["launches"], "launches_off": off["launches"],
          "peak_mib_on": on["peak_mib"], "peak_mib_off": off["peak_mib"],
          "its_per_sec_on": on["metrics"]["summary"]["per_scale_its_per_sec"],
          "its_per_sec_off": off["metrics"]["summary"]["per_scale_its_per_sec"],
          "seconds_on": on["seconds"], "seconds_off": off["seconds"]})
    if not (equal_png and equal_losses):
        raise AssertionError("cli: --remat on and off are not bit-equal at 1024 px")
    if not calls or set(on["forward_calls"]) != set(off["forward_calls"]) or \
            any(v != 2 * o for o, v in calls.values()):
        raise AssertionError(f"cli: remat did not run each forward twice: {calls}")

    # the stored path's peaks at sides[0]^2 and sides[1]^2, and sides[1]^2 under remat
    peaks = {}
    for px in sides:
        for route, flags in (("chain", []), ("plain", ["--unfused"])):
            for mode in (("off", "on") if px == sides[1] else ("off",)):
                out = f"{io.tmp}/big_{route}_{px}_{mode}.bmp"  # no time spent compressing
                # two chunks of 5: the second is the steady one
                run = _cli_run(torch, [c1024, io.styles[0], "--size", str(px), "--min-scale",
                                       str(px), "-i", "10", "--remat", mode, "-o", out]
                               + io.conf("config2_multiscale_1024") + io.common
                               + ["--chunk-size", "5"] + flags,
                               metrics_path=f"{io.tmp}/big.json", spies=route == "chain")
                peaks[(route, px, mode)] = run["peak_mib"][0]
                emit({"phase": "cli", "part": f"remat_{px}", "route": route, "remat": mode,
                      "peak_mib": run["peak_mib"][0], "seconds": run["seconds"],
                      "its_per_sec": run["metrics"]["summary"]["per_scale_its_per_sec"],
                      "launches": run["launches"], "forward_calls": run["forward_calls"],
                      "loss_per_step": run["curves"][0]})
                if route == "chain" and px == sides[1] and run["launches"]["conv_single"] == 0:
                    raise AssertionError(f"cli: the {px}^2 chain did not run the singles")
    fit = {}
    for route, current in (("chain", api.REMAT_AUTO_PIXELS_FUSED),
                           ("plain", api.REMAT_AUTO_PIXELS)):
        lo, hi = peaks[(route, sides[0], "off")], peaks[(route, sides[1], "off")]
        slope = (hi - lo) / (sides[1] ** 2 - sides[0] ** 2)  # MiB per pixel
        icpt = lo - slope * sides[0] ** 2
        px = (REMAT_SHARE * CARD_BYTES / 2**20 - icpt) / slope
        fit[route] = {"peak_mib": [lo, hi], "mib_per_mpx": slope * 1e6, "intercept_mib": icpt,
                      "threshold_px": px, "threshold_side": px ** 0.5, "constant_px": current}
    emit({"phase": "cli", "part": "remat_fit", "sides": list(sides),
          "share_of_80GB": REMAT_SHARE, "fit": fit,
          "remat_on_peak_mib": {route: peaks[(route, sides[1], "on")]
                                for route in ("chain", "plain")}})


def cli_resume(torch, io, steps):
    """``--resume`` from the middle of the last scale (see :func:`cli_check`,
    part 3)."""
    import os
    import shutil

    import numpy as np

    base = ([io.content[(1024, 1024)], io.styles[0], "-i", str(steps)]
            + io.conf("config2_multiscale_1024") + io.common)
    ck, full = f"{io.tmp}/ck", f"{io.tmp}/resume_full.png"
    _cli_run(torch, base + ["-o", full, "--checkpoint-dir", ck, "--checkpoint-every",
                            str(max(1, steps // 2))])
    saved = sorted(int(p.split("_")[1]) for p in os.listdir(ck) if p.startswith("step_"))
    shutil.rmtree(f"{ck}/step_{saved[-1]}")  # the latest is now half a scale before the end
    resumed = f"{io.tmp}/resume_resumed.png"
    run = _cli_run(torch, base + ["-o", resumed, "--checkpoint-dir", ck, "--resume"])
    equal = bool(np.array_equal(_png(full), _png(resumed)))
    emit({"phase": "cli", "part": "resume", "checkpoints": saved, "resumed_from_step": saved[-2],
          "resumed_sizes": run["sizes"], "resumed_steps": sum(map(len, run["curves"].values())),
          "bit_equal": equal})
    if not equal:
        raise AssertionError("cli: the resumed run does not end on the uninterrupted run's bits")


def cli_profile(torch, io):
    """``--profile-dir`` (see :func:`cli_check`, part 4)."""
    import os

    small = [io.content[(512, 512)], io.styles[0], "-i", "4", "--size", "256", "--min-scale",
             "256"] + io.common
    for attempt in range(3):  # a trace now and then comes back without device events
        prof = f"{io.tmp}/prof{attempt}"
        _cli_run(torch, small + ["--profile-dir", prof, "-o", f"{io.tmp}/prof.png"])
        traces = [p for p in os.listdir(prof) if p.endswith(".pt.trace.json")]
        with open(f"{prof}/{traces[0]}") as f:
            kernels = sorted({e["name"] for e in json.load(f)["traceEvents"]
                              if e.get("cat") == "kernel"})
        if kernels:
            break
    named = {k: any(k in n for n in kernels)
             for k in ("conv3x3_kernel", "gram_partial_kernel", "gram_fs_kernel", "tv_kernel")}
    emit({"phase": "cli", "part": "profile", "traces": traces, "attempts": attempt + 1,
          "kernel_names": len(kernels), "names_chain_kernels": named})
    if len(traces) != 1 or not all(named.values()):
        raise AssertionError(f"cli: the trace does not name the chain's kernels: {named}")


def cli_routes(torch, io, steps):
    """``--fused-block1`` and ``--unfused`` (see :func:`cli_check`, part 4)."""
    for part, flags, required, absent in (
            ("fused_block1", ["--fused-block1"], ("block1_full",),
             ("block1_packed", "conv_pair", "conv_single", "gram_tail", "conv_gram")),
            ("unfused", ["--unfused"], (), tuple(COUNTERS))):
        run = _cli_run(torch, [io.content[(512, 512)], io.styles[0], "-i", str(steps), "-o",
                               f"{io.tmp}/{part}.png"] + io.conf("config1_gatys_512_adam")
                       + io.common + flags)
        emit({"phase": "cli", "part": part, "launches": run["launches"],
              "seconds": run["seconds"], "peak_mib": run["peak_mib"]})
        if any(run["launches"][k] == 0 for k in required) or \
                any(run["launches"][k] != 0 for k in absent):
            raise AssertionError(f"cli {part}: wrong kernels launched: {run['launches']}")


def cli_web(torch, io):
    """``--web`` during one run, where aiohttp imports: a client thread
    fetches ``/`` and polls ``/image`` until a JPEG frame arrives while
    ``cli.main`` runs (see :func:`cli_check`, part 5)."""
    import importlib.util
    import threading
    import urllib.error
    import urllib.request

    if importlib.util.find_spec("aiohttp") is None:
        emit({"phase": "cli", "part": "web", "run": False,
              "reason": "aiohttp is not installed here: the --web check was not run"})
        return
    port = _free_port()
    got = {}

    def client():
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while time.time() < deadline and "image" not in got:
            try:
                if "index" not in got:
                    with urllib.request.urlopen(base + "/", timeout=5) as r:
                        got["index"] = (r.status, "WebSocket" in r.read().decode())
                with urllib.request.urlopen(base + "/image", timeout=5) as r:
                    got["image"] = r.read()[:2] == b"\xff\xd8"
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.05)  # not serving yet, or no frame yet (404)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    run = _cli_run(torch, [io.content[(512, 512)], io.styles[0], "-i", "200", "--size", "256",
                           "--min-scale", "256", "--web", "--port", str(port), "-o",
                           f"{io.tmp}/web.png"] + io.common)
    thread.join(timeout=130)
    emit({"phase": "cli", "part": "web", "run": True, "got": got, "seconds": run["seconds"]})
    if thread.is_alive() or got.get("index") != (200, True) or got.get("image") is not True:
        raise AssertionError(f"cli: --web served {got} during the run")


def cli_python_m(io):
    """``python -m style_transfer_tpu_torch`` in a subprocess (see
    :func:`cli_check`, part 6)."""
    import os
    from pathlib import Path

    repo = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    pm = [sys.executable, "-m", "style_transfer_tpu_torch"]
    t0 = time.perf_counter()
    version = subprocess.run(pm + ["--version"], cwd=repo, env=env, capture_output=True,
                             text=True, timeout=300, check=True).stdout.strip()
    layers = subprocess.run(pm + ["--list-layers"], cwd=repo, env=env, capture_output=True,
                            text=True, timeout=300, check=True).stdout
    out = f"{io.tmp}/dash_m.png"
    proc = subprocess.run(pm + [io.content[(512, 512)], io.styles[0], "-o", out, "-i", "4"]
                          + io.conf("config1_gatys_512_adam") + io.common, cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    shape = list(_png(out).shape) if proc.returncode == 0 else None
    emit({"phase": "cli", "part": "python_m", "version": version,
          "list_layers": layers.splitlines(), "run_rc": proc.returncode, "run_out_shape": shape,
          "seconds": time.perf_counter() - t0})
    if proc.returncode != 0:
        raise AssertionError(f"cli: the python -m run failed: {proc.stderr[-2000:]}")
    if not version.startswith("style_transfer_tpu_torch ") or "vgg19: conv1_1" not in layers \
            or shape != [512, 512, 3]:
        raise AssertionError("cli: python -m printed or wrote the wrong thing")


def cli_check(torch, steps):
    """Phase 13: the command line, ``style_transfer_tpu_torch.cli.main`` in
    this process (so the launch counts can be set to 0 before each run and
    read after it), on seeded PNGs with ``--random-weights`` and chunks of
    10:

    1. configurations 1-5 (``configs/*.toml``) at their own sizes, ``-i
       steps`` (CLI flags override the TOML): configurations 1-4 on a square
       content, 3 with two styles, 5 on a 16:9 content 3840 px wide; each
       exits 0 with an output PNG of the expected shape and a
       ``--metrics-out`` file of finite losses, every scale falls by chunk
       peaks, its path's kernels launch (in every scale for 1-4) and no
       opt-in kernel does; the steady it/s and peak memory per scale, the
       launches per scale and the wall seconds are printed;
    2. remat: configuration 2 at 1024 px with ``--remat on`` and ``off``:
       the output PNG and every loss record bit-equal, each chain kernel
       wrapper's forward called twice as often under remat; then one scale
       of 10 steps at 4096x4096 both ways, on the chain (singles) and on the
       plain path (``--unfused``), and the stored path's peaks at 2048^2 and
       4096^2 on both, the linear fit in pixels and where it reaches
       ``REMAT_SHARE`` of the card's 80 GB (the derivation of
       ``api.REMAT_AUTO_PIXELS*``);
    3. resume: configuration 2 with ``--checkpoint-dir``, the last
       checkpoint removed so that the latest is in the middle of the last
       scale, ``--resume``: the output PNG equal to the uninterrupted run's;
    4. ``--profile-dir``: the trace exists and names the chain's kernels;
       ``--fused-block1`` launches ``block1_full`` and no chain kernel;
       ``--unfused`` launches no kernel of the port;
    5. ``--web`` where aiohttp imports (else a line says it was not run);
    6. ``python -m style_transfer_tpu_torch`` in a subprocess: ``--version``,
       ``--list-layers`` and a short configuration-1 run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cli_phase_")
    try:
        io = _CliInputs(tmp, {hw for hw, *_ in CLI_CONFIGS.values()})
        cli_configs(torch, io, steps)
        cli_remat(torch, io, steps)
        cli_resume(torch, io, steps)
        cli_profile(torch, io)
        cli_routes(torch, io, steps)
        cli_web(torch, io)
        cli_python_m(io)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The pipeline phase: the chain's kernels that the 256 -> 1024 px runs must
# launch, and the share of a chunk's device time that an idle gap between
# two chunks may take at 2048^2 with the CLI's sinks, beyond the host time
# by which the longest callback outlasts a chunk.
PIPE_CHAIN = ("block1_packed", "conv_pair", "conv_gram", "tv_loss")
GAP_SHARE = 0.05
#: The CLI's sinks that the gap part fires every chunk, each timed alone.
SINKS = ("Printer", "MetricsRecorder", "SnapshotSaver", "CheckpointManager")
#: What ``torch.cuda.set_sync_debug_mode("warn")`` says at each synchronizing
#: call (its first use also warns that the mode is a prototype feature).
SYNC_WARNING = "called a synchronizing CUDA operation"


class _DispatchSpy:
    """Wraps ``StyleTransfer._dispatch_chunk`` of one instance: counts the
    chunks queued, and with ``sync_mode`` counts the synchronizing CUDA calls
    made while each is queued (``torch.cuda.set_sync_debug_mode``), by the
    file and line that made them; with ``markers`` it launches the empty
    kernel just before and just after each chunk, so that a profiler trace
    shows where each chunk's device work begins and ends. Each sync is
    recorded as the innermost frames of the Python stack that made it."""

    def __init__(self, torch, st, *, sync_mode=None, markers=False):
        self.torch, self.st, self.sync_mode, self.markers = torch, st, sync_mode, markers
        self.queued, self.syncs, self.chunks = 0, [], []

    def __enter__(self):
        import traceback
        import warnings

        from style_transfer_tpu_torch.ops.kernels import _launch

        real, torch = self.st._dispatch_chunk, self.torch

        def dispatch(*args, **kw):
            if self.markers:
                _launch.noop()
            if self.sync_mode is None:
                rec = real(*args, **kw)
            else:
                syncs = []

                def show(message, category, filename, lineno, *rest):
                    if SYNC_WARNING in str(message):
                        syncs.append(" < ".join(f"{f.filename}:{f.lineno}:{f.name}" for f in
                                                reversed(traceback.extract_stack()[-8:-2])))

                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = show
                    torch.cuda.set_sync_debug_mode(self.sync_mode)
                    try:
                        rec = real(*args, **kw)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                self.syncs.append(syncs)
            if self.markers:
                _launch.noop()
            self.chunks.append((tuple(args[1].shape[1:3]), kw["done_iters"] + kw["n"]))
            self.queued += 1
            return rec

        self.st._dispatch_chunk = dispatch
        return self

    def __exit__(self, *exc):
        del self.st._dispatch_chunk  # the class's method again


def _pending_launch_limit(torch):
    """How many empty launches the host queues behind a kernel that keeps the
    card busy for about a second before a launch call blocks: the depth of
    CUDA's launch queue (None if 8192 never block)."""
    from style_transfer_tpu_torch.ops.kernels import _launch

    torch.cuda._sleep(1000)  # both kernels loaded before the count starts
    _launch.noop()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # clock cycles: about a second on the H100
    limit = None
    for i in range(8192):
        t0 = time.perf_counter()
        _launch.noop()
        if time.perf_counter() - t0 > 0.05:
            limit = i
            break
    torch.cuda.synchronize()
    return limit


def _pipeline_syncs(torch, st, r):
    """Part 1 of :func:`pipeline_check`; returns what failed."""
    import dataclasses

    import numpy as np

    from style_transfer_tpu_torch import StylizeConfig, linesearch
    from style_transfer_tpu_torch.optim import OptimizerSpec

    img = {n: (r.rand(n, n, 3).astype(np.float32), r.rand(n, n, 3).astype(np.float32))
           for n in (512, 1024, 2048)}
    base = StylizeConfig(size=512, min_scale=512, iterations=(20,), chunk_size=10)
    routes = {
        "chain_256_1024": (1024, dataclasses.replace(base, size=1024, min_scale=256)),
        "singles_2048": (2048, dataclasses.replace(base, size=2048, min_scale=2048)),
        "fused_block1": (512, dataclasses.replace(base, fused_block1=True)),
        "unfused": (512, dataclasses.replace(base, use_fused=False)),
        "remat": (512, dataclasses.replace(base, remat=True)),
        "avg_decay": (512, dataclasses.replace(base, avg_decay=0.9)),
    }
    out = {}
    for name, (n, cfg) in routes.items():
        with _DispatchSpy(torch, st, sync_mode="warn") as spy:
            st.stylize(*img[n], cfg)
        out[name] = {"chunks": spy.queued, "syncs_per_chunk": [len(c) for c in spy.syncs],
                     "where": sorted({w for c in spy.syncs for w in c})}
    with _DispatchSpy(torch, st, sync_mode="error") as spy:  # raises on the first one
        st.stylize(*img[1024], routes["chain_256_1024"][1])
    error_mode_chunks = spy.queued
    lbfgs = dataclasses.replace(base, optimizer=OptimizerSpec("lbfgs", memory_size=10),
                                tv_weight=8.0)
    reads0 = linesearch.host_reads.n
    with _DispatchSpy(torch, st, sync_mode="warn") as spy:
        st.stylize(*img[512], lbfgs)
    reads = linesearch.host_reads.n - reads0
    syncs = sum(len(c) for c in spy.syncs)
    emit({"phase": "pipeline", "part": "syncs", "adam_routes": out,
          "chunks_under_error_mode": error_mode_chunks,
          "lbfgs_512": {"chunks": spy.queued, "syncs": syncs, "linesearch_host_reads": reads,
                        "where": sorted({w for c in spy.syncs for w in c})}})
    bad = {k: v for k, v in out.items() if any(v["syncs_per_chunk"]) or not v["chunks"]}
    failures = []
    if bad:
        failures.append(f"synchronizing calls in an Adam chunk: {bad}")
    if syncs != reads or not reads:
        failures.append(f"an L-BFGS chunk made {syncs} synchronizing calls for {reads} "
                        "line-search reads")
    return failures


def _observed_run(torch, st, content, style, cfg, *, late_images=False, **kw):
    """One ``stylize()`` with a callback that keeps every event's
    coordinates, losses and ``get_image()`` (fetched inside the callback,
    every other one from a second thread as the web monitor does), the
    chunks queued when it ran, and the launch counts of the run."""
    from concurrent.futures import ThreadPoolExecutor

    counters = _counters()
    for c in counters.values():
        c.n = 0
    got = {"coords": [], "losses": [], "images": [], "ahead": [], "events": []}
    with ThreadPoolExecutor(max_workers=1) as pool, _DispatchSpy(torch, st) as spy:
        def callback(ev):  # chunks queued after this event's own
            queued = spy.chunks[:spy.queued]
            own = max(i for i, c in enumerate(queued) if c == (tuple(ev.size), ev.iteration))
            got["ahead"].append(len(queued) - 1 - own)
            got["coords"].append((ev.scale_index, ev.iteration, ev.done))
            got["losses"].append({k: v.copy() for k, v in ev.losses.items()})
            fetch = pool.submit(ev.get_image).result if len(got["images"]) % 2 else ev.get_image
            got["images"].append(fetch())
            if late_images:
                got["events"].append(ev)

        out = st.stylize(content, style, cfg, callback=callback, **kw)
    got["launches"] = {k: c.n for k, c in counters.items()}
    got["queued_total"] = spy.queued
    return out, got


def _same_run(name, a, b):
    """Raises unless two observed runs are equal bit for bit."""
    import numpy as np

    (out_a, ga), (out_b, gb) = a, b
    diffs = []
    if not np.array_equal(out_a, out_b):
        diffs.append(f"image (max abs {float(np.abs(out_a - out_b).max())})")
    if ga["coords"] != gb["coords"]:
        diffs.append(f"events {ga['coords']} != {gb['coords']}")
    for i, (la, lb, ia, ib) in enumerate(zip(ga["losses"], gb["losses"], ga["images"],
                                             gb["images"])):
        if la.keys() != lb.keys() or not all(np.array_equal(la[k], lb[k]) for k in la):
            diffs.append(f"losses of event {i}")
        if not np.array_equal(ia, ib):
            diffs.append(f"get_image of event {i}")
    if diffs:
        raise AssertionError(f"pipeline {name}: pipelined and sequential differ: {diffs[:6]}")


def _pipeline_bits(torch, st, r):
    """Parts 2 and 3 of :func:`pipeline_check`."""
    import dataclasses

    import numpy as np

    from style_transfer_tpu_torch import StylizeConfig
    from style_transfer_tpu_torch.optim import OptimizerSpec

    content = r.rand(1024, 1024, 3).astype(np.float32)
    style = r.rand(1024, 1024, 3).astype(np.float32)
    chain = StylizeConfig(size=1024, min_scale=256, iterations=(30,), chunk_size=10)
    runs = {
        "chain": chain,
        "avg_decay": dataclasses.replace(chain, avg_decay=0.9),
        # stop_tol=1 counts every chunk as a stall: each scale stops at its
        # third chunk of six, with the fourth and fifth queued
        "early_stop": dataclasses.replace(chain, iterations=(60,), stop_tol=1.0, stop_patience=2),
        "lbfgs": dataclasses.replace(chain, size=512, optimizer=OptimizerSpec(
            "lbfgs", memory_size=10), tv_weight=8.0),
    }
    report = {}
    for name, cfg in runs.items():
        seq = _observed_run(torch, st, content, style,
                            dataclasses.replace(cfg, pipeline_chunks=False))
        pipe = _observed_run(torch, st, content, style,
                             dataclasses.replace(cfg, pipeline_chunks=True),
                             late_images=name == "chain")
        _same_run(name, seq, pipe)
        g = pipe[1]
        ahead = g["ahead"]
        report[name] = {"events": g["coords"], "queued": g["queued_total"],
                        "chunks_queued_beyond_the_processed_one": ahead,
                        "launches": g["launches"], "bit_equal": True}
        if max(ahead) < 2:
            raise AssertionError(f"pipeline {name}: no callback ran with two chunks queued "
                                 f"beyond its own: {ahead}")
        if name == "chain":
            missing = [k for k in PIPE_CHAIN if g["launches"][k] == 0]
            if missing:
                raise AssertionError(f"pipeline: kernels never launched on the path: {missing}")
            late = [ev.get_image() for ev in g["events"]]  # after later chunks ran and freed
            if not all(np.array_equal(x, y) for x, y in zip(late, g["images"])):
                raise AssertionError("pipeline: a late get_image() differs from its callback's")
        if name == "early_stop":
            scales = {sc for sc, _, _ in g["coords"]}
            ends = [it for _, it, _ in g["coords"] if it == 30]
            if len(ends) != len(scales) or g["queued_total"] != 5 * len(scales) \
                    or not g["coords"][-1][2]:
                raise AssertionError(f"pipeline early_stop: not stopped mid-scale with two "
                                     f"chunks queued: {g['coords']}, {g['queued_total']}")
    emit({"phase": "pipeline", "part": "bit_equal", "runs": report})

    # resume from get_state() inside the callback of chunk 1 of 6
    one = StylizeConfig(size=512, min_scale=512, iterations=(60,), chunk_size=10,
                        pipeline_chunks=True)
    saved = []
    with _DispatchSpy(torch, st) as spy:
        full = st.stylize(content, style, one, callback=lambda ev: saved.append(
            (spy.queued, ev.get_state())) if ev.iteration == 10 else None)
    resumed = st.stylize(content, style, one, resume_state=saved[0][1])
    equal = bool(np.array_equal(full, resumed))
    emit({"phase": "pipeline", "part": "resume", "queued_when_taken": saved[0][0],
          "resumed_from_iteration": int(saved[0][1]["iteration"]), "bit_equal": equal})
    if saved[0][0] < 3 or not equal:
        raise AssertionError(f"pipeline: resume from chunk 1 with {saved[0][0]} queued: "
                             f"bit_equal={equal}")


def _chunk_gaps(torch, prof, chunks):
    """From a trace of ``chunks`` chunks queued between marker launches: each
    chunk's device span and busy time on the compute stream, the idle time
    between the last kernel of one chunk and the first of the next, in ms,
    and the seconds from the first chunk's end to the last one's."""
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ev) if "noop_kernel" in e.name]
    if len(marks) != 2 * chunks:
        return None
    stream = ev[marks[0]].device_resource_id
    spans, busy, gaps, ends = [], [], [], []  # ms, ms, ms, us
    for k in range(chunks):
        mine = [e for e in ev[marks[2 * k] + 1:marks[2 * k + 1]]
                if e.device_resource_id == stream]
        first, last = mine[0].time_range.start, max(e.time_range.end for e in mine)
        spans.append((last - first) / 1e3)
        busy.append(sum(e.time_range.elapsed_us() for e in mine) / 1e3)
        if ends:
            gaps.append((first - ends[-1]) / 1e3)
        ends.append(last)
    return spans, busy, gaps, (ends[-1] - ends[0]) / 1e6


def _timed_sink(fn, times):
    """``fn`` as a callback that appends its host seconds to ``times``."""
    def timed(ev):
        t0 = time.perf_counter()
        fn(ev)
        times.append(time.perf_counter() - t0)
    return timed


def _pipeline_gap(torch, st, r):
    """Part 4 of :func:`pipeline_check`."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from style_transfer_tpu_torch import StylizeConfig
    from style_transfer_tpu_torch.utils.ckpt import CheckpointManager
    from style_transfer_tpu_torch.utils.progress import MetricsRecorder, Printer, fanout
    from style_transfer_tpu_torch.utils.snapshots import SnapshotSaver

    content = r.rand(2048, 2048, 3).astype(np.float32)
    style = r.rand(2048, 2048, 3).astype(np.float32)
    chunk, chunks = 50, 8
    tmp = tempfile.mkdtemp(prefix="pipeline_phase_")
    report = {}
    try:
        for pipelined in (True, False):
            cfg = StylizeConfig(size=2048, min_scale=2048, iterations=(chunk * chunks,),
                                chunk_size=chunk, pipeline_chunks=pipelined)
            for attempt in range(3):  # a trace now and then comes back without device events
                metrics, host_s, per_sink = MetricsRecorder(), [], {n: [] for n in SINKS}
                sinks = fanout(*(_timed_sink(fn, per_sink[n]) for n, fn in zip(SINKS, (
                    Printer(every=chunk), metrics, SnapshotSaver(f"{tmp}/out.png", every=chunk),
                    CheckpointManager(f"{tmp}/ck{int(pipelined)}", every=chunk,
                                      keep=2).callback))))

                def callback(ev):
                    t0 = time.perf_counter()
                    sinks(ev)
                    host_s.append(time.perf_counter() - t0)

                counters = _counters()
                for c in counters.values():
                    c.n = 0
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                        _DispatchSpy(torch, st, markers=True):
                    st.stylize(content, style, cfg, callback=callback)
                    torch.cuda.synchronize()
                found = _chunk_gaps(torch, prof, chunks)
                if found is not None:
                    break
            if found is None:
                raise AssertionError("pipeline: no trace with the chunks' device events")
            spans, busy, gaps, after_first = found
            summary = metrics.summary()
            report["pipelined" if pipelined else "sequential"] = {
                "chunk_device_ms": spans, "chunk_busy_ms": busy, "gap_ms": gaps,
                "callback_host_ms": [t * 1e3 for t in host_s],
                "sink_host_ms": {n: [t * 1e3 for t in ts] for n, ts in per_sink.items()},
                "its_per_sec": [rec["its_per_sec"] for rec in metrics.records],
                "its_per_sec_steady": summary["per_scale_its_per_sec"][0],
                # the card's pace after the first chunk, the gaps between chunks included
                "its_per_sec_with_gaps": chunk * (chunks - 1) / after_first,
                "launches": {k: c.n for k, c in counters.items()}, "trace_attempts": attempt + 1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pipe, seq = report["pipelined"], report["sequential"]
    chunk_ms = statistics.mean(pipe["chunk_device_ms"])
    # The card can hide only the host work that fits in a chunk: where the
    # callbacks take longer, the loop waits for them, and the gap may grow by
    # that excess; with callbacks shorter than a chunk, the limit is
    # GAP_SHARE of a chunk alone.
    excess_ms = max(0.0, max(pipe["callback_host_ms"]) - chunk_ms)
    limit_ms = GAP_SHARE * chunk_ms + excess_ms
    emit({"phase": "pipeline", "part": "gap_2048", "chunk": chunk, "chunks": chunks,
          "sinks": list(SINKS), "gap_share_limit": GAP_SHARE,
          "max_gap_share": max(pipe["gap_ms"]) / chunk_ms,
          "callback_below_chunk": excess_ms == 0.0, "callback_excess_ms": excess_ms,
          "gap_limit_ms": limit_ms, **report})
    if pipe["launches"]["conv_single"] == 0:
        raise AssertionError("pipeline: the 2048^2 scale did not run on the singles")
    if not max(pipe["gap_ms"]) < limit_ms:
        raise AssertionError(f"pipeline: idle gaps {pipe['gap_ms']} ms between chunks of "
                             f"{chunk_ms} ms device time, above {limit_ms} ms (callbacks "
                             f"{pipe['callback_host_ms']} ms)")
    if not min(seq["gap_ms"]) > GAP_SHARE * chunk_ms:  # the trace sees the host's waits
        raise AssertionError(f"pipeline: sequential gaps {seq['gap_ms']} ms, callbacks "
                             f"{seq['callback_host_ms']} ms: the trace misses the waits")


def _pipeline_cli(torch, r, steps):
    """Part 5 of :func:`pipeline_check`."""
    import shutil
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="pipeline_cli_")
    try:
        io = _CliInputs(tmp, {(1024, 1024)})
        base = ([io.content[(1024, 1024)], io.styles[0], "-i", str(steps)]
                + io.conf("config2_multiscale_1024") + io.common)
        runs = {}
        for name, flags in (("pipelined", []), ("sequential", ["--no-pipeline"])):
            run = _cli_run(torch, base + ["-o", f"{tmp}/{name}.png"] + flags,
                           metrics_path=f"{tmp}/{name}.json")
            runs[name] = (run, _png(f"{tmp}/{name}.png"),
                          [rec["loss"] for rec in run["metrics"]["records"]])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (pr, pimg, ploss), (sr, simg, sloss) = runs["pipelined"], runs["sequential"]
    equal = bool(np.array_equal(pimg, simg)) and ploss == sloss and pr["curves"] == sr["curves"]
    emit({"phase": "pipeline", "part": "cli_config2", "bit_equal": equal, "steps": steps,
          **{name: {"its_per_sec_steady": run["metrics"]["summary"]["per_scale_its_per_sec"],
                    "peak_mib": run["peak_mib"], "seconds": run["seconds"]}
             for name, (run, _, _) in runs.items()}})
    if not equal:
        raise AssertionError("pipeline: --no-pipeline changed the PNG or the losses")


def _pipeline_memory(torch, st, r):
    """Part 6 of :func:`pipeline_check`."""
    import numpy as np

    from style_transfer_tpu_torch import StylizeConfig

    report = {}
    for side in (2048, 4096):
        content = r.rand(side, side, 3).astype(np.float32)
        style = r.rand(1024, 1024, 3).astype(np.float32)
        for pipelined in (True, False):
            cfg = StylizeConfig(size=side, min_scale=side, iterations=(10,), chunk_size=2,
                                pipeline_chunks=pipelined)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            st.stylize(content, style, cfg, callback=lambda ev: None)
            torch.cuda.synchronize()
            report[f"{side}_{'pipelined' if pipelined else 'sequential'}"] = \
                torch.cuda.max_memory_allocated() / 2**20
        # two records beyond the live state: image, Adam's two moments and the display image
        report[f"{side}_extra_mib"] = report[f"{side}_pipelined"] - report[f"{side}_sequential"]
        report[f"{side}_two_records_mib"] = 2 * 4 * side * side * 3 * 4 / 2**20
    emit({"phase": "pipeline", "part": "memory", "steps": 10, "chunk": 2, "peak_mib": report})


def pipeline_check(torch, params, mean, std, steps):
    """Phase 14: the pipelined chunk loop of ``stylize()`` (``api.py``) on
    the card, at VGG-19's full widths, seeded weights and noise, Adam and the
    default layers unless said:

    1. syncs: every chunk queued on six routes (the chain over 256 -> 1024
       px, the singles at 2048^2, ``fused_block1``, ``use_fused=False``,
       ``remat=True``, ``avg_decay=0.9``; two chunks of 10 a scale) makes no
       synchronizing CUDA call (``torch.cuda.set_sync_debug_mode("warn")``,
       counted by file and line; the chain route once more under
       ``"error"``); an L-BFGS chunk (configuration 4's optimizer, 512 px)
       makes exactly its line-search reads; and the depth of CUDA's
       launch queue;
    2. bit-equality: ``stylize()`` pipelined and sequential over 256 -> 1024
       px (30 steps a scale in chunks of 10), the same with
       ``avg_decay=0.9``, with ``stop_tol=1`` (each scale stops at chunk 3
       of 6 with chunks 4 and 5 queued), and L-BFGS over 256 -> 512: the
       image, every event's coordinates and losses, and every event's
       ``get_image()`` fetched inside the callback (every other one from a
       second thread) equal bit for bit; in the first run, each
       ``get_image()`` again after the run, and the chain's kernels launched;
    3. resume: a pipelined run's ``get_state()`` in the callback of chunk 1
       of 6 at 512 px, taken with chunks 2 and 3 queued, resumes to the
       uninterrupted run's bits;
    4. the idle gap: 2048^2 in eight chunks of 50 with the CLI's sinks
       (``Printer``, ``MetricsRecorder``, a ``SnapshotSaver`` and a
       ``CheckpointManager`` that fire every chunk), pipelined and
       sequential, under the profiler with an empty kernel launched around
       each chunk: each chunk's device time, the idle time between
       consecutive chunks' kernels on the compute stream, the callback's
       host time, each sink's, and the it/s; pipelined, every gap must be
       under ``GAP_SHARE`` of a chunk's device time plus the excess of the
       longest callback over a chunk (none where every callback is shorter),
       and sequential, every gap above ``GAP_SHARE`` of a chunk;
    5. the command line: configuration 2 through ``cli.main`` with and
       without ``--no-pipeline``, ``steps`` a scale: the same PNG and
       losses, and it/s and peak memory per scale of both;
    6. memory: the peak at 2048^2 and 4096^2, one scale of 10 steps in
       chunks of 2 (so that records are in flight), both ways."""
    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer

    st = StyleTransfer(params, mean=mean, std=std, device="cuda")
    r = np.random.RandomState(9)
    emit({"phase": "pipeline", "part": "launch_queue",
          "pending_launch_limit": _pending_launch_limit(torch)})
    failures = _pipeline_syncs(torch, st, r)  # raised after the other parts have run
    _pipeline_bits(torch, st, r)
    _pipeline_gap(torch, st, r)
    _pipeline_cli(torch, r, steps)
    _pipeline_memory(torch, st, r)
    if failures:
        raise AssertionError(f"pipeline: {failures}")


# ---------------------------------------------------------------- phase 15: mesh

#: The shard counts of the mesh phase's objective parts; the one card
#: repeats in each mesh.
MESH_SHARDS = (2, 4, 8)
#: The five chain kernels that run per shard under a mesh.
MESH_KERNELS = ("block1_packed", "conv_pair", "conv_single", "gram_tail", "conv_gram")
#: The mesh phase's sizes: the large and the small objective's side, and
#: configuration 5's content (H, W) with its smallest scale's long side.
MESH_SIDE, MESH_SMALL_SIDE, MESH_TINY_SIDE = 2048, 512, 128
CONFIG5_HW, CONFIG5_MIN_SCALE = (2160, 3840), 240
#: Configuration 5's 1920 px scale: pool3 has odd rows, so block 4 and
#: conv5_1 run the plain sharded VGG (cuDNN per shard) and ``pallas_gram``.
CONFIG5_ODD_HW = (1080, 1920)


class _ShardLaunches:
    """While active, records the forward launches each chain kernel makes on
    each shard: ``parallel.mesh.map_shards`` calls the kernel once per shard,
    in shard order, and the launch counts are read around each call. The
    backward's launches come later, from autograd, and count in the totals
    only."""

    def __init__(self):
        self.per = {}

    def __enter__(self):
        from style_transfer_tpu_torch.parallel import mesh as M

        self._real, counters = M.map_shards, _counters()

        def spy(fn, xs, halo, **kw):
            index = iter(range(len(xs)))

            def counted(*a):
                i = next(index)
                before = {k: c.n for k, c in counters.items()}
                out = fn(*a)
                for k, c in counters.items():
                    if c.n > before[k]:
                        row = self.per.setdefault(k, [0] * len(xs))
                        row += [0] * (len(xs) - len(row))
                        row[i] += c.n - before[k]
                return out

            return self._real(counted, xs, halo, **kw)

        M.map_shards = spy
        return self

    def __exit__(self, *exc):
        from style_transfer_tpu_torch.parallel import mesh as M

        M.map_shards = self._real


def _mesh_setup(torch, st, cfg, content, style):
    from style_transfer_tpu_torch.api import _style_size
    from style_transfer_tpu_torch.utils import imgio

    h, w = content.shape[:2]
    c = st._capture_content(cfg, torch.from_numpy(content)[None].cuda())
    s_img = imgio.resize_image(torch.from_numpy(style)[None].cuda(),
                               _style_size(style.shape[:2], (h, w), cfg.style_scale))
    return c, st._capture_style(cfg, s_img)


def _mesh_objective(torch, st, cfg, content, style, image_np, *, time_it=True):
    """The objective of ``st`` at one image: its loss terms and image
    gradient, the launches of one evaluation with its backward (every count
    set to 0 just before and read just after), the forward launches per
    shard, the route, and, with ``time_it``, an Adam step's wall and device
    ms and the peak device memory of a step."""
    from style_transfer_tpu_torch.optim import make_step_fn

    c, s = _mesh_setup(torch, st, cfg, content, style)
    objective = st._build_objective(cfg)
    image = torch.from_numpy(image_np)[None].cuda()
    counters = _counters()
    for k in counters.values():
        k.n = 0
    with _ShardLaunches() as spy:
        x = image.clone().requires_grad_(True)
        loss, terms = objective(x, c, s)
        (g,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    out = {"terms": {k: float(v.detach()) for k, v in terms.items()}, "grad": g.detach().cpu(),
           "launches": {k: v.n for k, v in counters.items() if v.n},
           "forward_launches_per_shard": spy.per, "route": [list(p) for p in st.last_route]}
    if time_it:
        step, opt = make_step_fn(lambda im: objective(im, c, s), cfg.optimizer)
        state = [image, opt.init(image)]

        def one():
            state[0], state[1], _ = step(state[0], state[1])

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one()
        torch.cuda.synchronize()
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        out["peak_above_start_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        out["step_wall_ms"] = statistics.median(_wall_ms(torch, one, reps=5, warmup=1))
        (out["step_device_ms"], out["device_launches_per_step"],
         out["device_ms_by_kernel"]) = _device_by_name(torch, one)
    return out


def _device_by_name(torch, fn, reps: int = 3, top: int = 12):
    """``(ms, launches, {name: ms})`` per call of ``fn`` on the card: the
    summed device time of the profiler's kernels and copies, their count,
    and the ``top`` names by time (each name cut to 70 characters)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):  # a trace now and then comes back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by, n = {}, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name[:70]
                by[key] = by.get(key, 0.0) + e.time_range.elapsed_us() / reps / 1e3
                n += 1
        if by:
            names = dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])
            return sum(by.values()), n / reps, names
    raise RuntimeError("the profiler recorded no device time on the card in three traces")


def _compare(a, b):
    """Relative errors of ``a``'s loss terms and image gradient against
    ``b``'s, and the gradients' cosine (in float64)."""
    rels = {k: abs(a["terms"][k] - b["terms"][k]) / max(abs(b["terms"][k]), 1e-30)
            for k in b["terms"]}
    ga, gb = a["grad"].double().flatten(), b["grad"].double().flatten()
    return {"term_rel": rels, "grad_rel": float((ga - gb).norm() / gb.norm()),
            "grad_cos": float((ga @ gb) / (ga.norm() * gb.norm()))}


@contextlib.contextmanager
def _route(route):
    """``natural``: the size rule's forms; ``forced``: every two-conv segment
    as the fused pair and conv5_1 as ``gram_tail`` (the forms the 2048^2
    scale does not pick itself)."""
    from style_transfer_tpu_torch.ops.kernels import dispatch

    saved = dispatch.segment_impl, dispatch.gram_tail_impl
    if route == "forced":
        dispatch.segment_impl = lambda *a, **k: "pair"
        dispatch.gram_tail_impl = lambda *a, **k: "gram_tail"
    try:
        yield
    finally:
        dispatch.segment_impl, dispatch.gram_tail_impl = saved


def _mesh_objectives(torch, params, mean, std, *, hw, shards, routes, devices, witness):
    """Parts 1 to 3 of :func:`mesh_check`: at ``hw`` = (H, W) and per
    route, the unsharded chain, then a mesh of each count of ``shards``
    (devices taken from ``devices``), each held against the unsharded chain
    and the plain fp32 witness; returns the failures and each run's
    launches by ``(route, shards)``."""
    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.ops.kernels import tolerances as T
    from style_transfer_tpu_torch.parallel import mesh as M

    h, w = hw
    r = np.random.RandomState(h)
    content = r.rand(h, w, 3).astype(np.float32)
    style = r.rand(h, w, 3).astype(np.float32)
    image = np.clip(content + 0.1 * r.randn(h, w, 3), 0, 1).astype(np.float32)
    cfg = StylizeConfig(size=(h, w))
    failures, launches = [], {}
    wit = None
    if witness:
        st32 = StyleTransfer(params, mean=mean, std=std, device="cuda",
                             compute_dtype=torch.float32)
        wit = _mesh_objective(torch, st32, StylizeConfig(size=(h, w), use_fused=False), content,
                              style, image, time_it=False)
    for route in routes:
        with _route(route):
            ref = _mesh_objective(torch, StyleTransfer(params, mean=mean, std=std,
                                                       device="cuda"), cfg, content, style, image)
            for n in shards:
                mesh = M.make_mesh(devices=list(devices)[:n])
                st = StyleTransfer(params, mean=mean, std=std, device=mesh.home, mesh=mesh)
                got = _mesh_objective(torch, st, cfg, content, style, image)
                launches[(route, n)] = got["launches"]
                vs_ref = _compare(got, ref)
                vs_wit = _compare(got, wit) if wit is not None else None
                ref_wit = _compare(ref, wit) if wit is not None else None
                per = got["forward_launches_per_shard"]
                kernels = [k for k in MESH_KERNELS if k in ref["launches"]]
                n_used = M.shard_count(h, n)
                not_every_shard = {k: per.get(k) for k in kernels
                                   if len(per.get(k, [])) != n_used or not all(per.get(k, []))}
                ratio = {k: got["launches"].get(k, 0) / ref["launches"][k] for k in kernels}
                emit({"phase": "mesh", "part": f"objective_{h}x{w}", "route": route,
                      "devices": [str(d) for d in mesh.devices], "shards_used": n_used,
                      "forms": got["route"], "terms": got["terms"],
                      "vs_unsharded": vs_ref, "vs_plain_fp32": vs_wit,
                      "unsharded_vs_plain_fp32": ref_wit,
                      "launches": got["launches"], "unsharded_launches": ref["launches"],
                      "launch_ratio": ratio, "forward_launches_per_shard": per,
                      "step_wall_ms": got["step_wall_ms"],
                      "unsharded_step_wall_ms": ref["step_wall_ms"],
                      "step_device_ms": got["step_device_ms"],
                      "unsharded_step_device_ms": ref["step_device_ms"],
                      "device_launches_per_step": got["device_launches_per_step"],
                      "unsharded_device_launches_per_step": ref["device_launches_per_step"],
                      "device_ms_by_kernel": got["device_ms_by_kernel"],
                      "unsharded_device_ms_by_kernel": ref["device_ms_by_kernel"],
                      "peak_mib": got["peak_mib"], "unsharded_peak_mib": ref["peak_mib"],
                      "tol": {"terms": T.TOL_MESH_TERMS, "grad_rel": T.TOL_MESH_GRAD,
                              "grad_cos": T.TOL_MESH_COS}})
                bad = []
                if (max(vs_ref["term_rel"].values()) > T.TOL_MESH_TERMS
                        or vs_ref["grad_rel"] > T.TOL_MESH_GRAD
                        or vs_ref["grad_cos"] < T.TOL_MESH_COS):
                    bad.append(f"departs from the unsharded chain: {vs_ref}")
                if vs_wit is not None and (max(vs_wit["term_rel"].values()) > TOL_TERMS
                                           or vs_wit["grad_rel"] > TOL_GRAD_REL
                                           or vs_wit["grad_cos"] < TOL_GRAD_COS):
                    bad.append(f"departs from the plain fp32 witness: {vs_wit}")
                if not_every_shard:
                    bad.append(f"kernels not launched on every shard: {not_every_shard}")
                if any(v != n_used for v in ratio.values()):
                    bad.append(f"launches not {n_used}x the unsharded chain's: {ratio}")
                # no full-size gather: the stored activations grow by the halo
                # rows only (a pair's 2 rows each way at the deepest two-conv
                # level, pool3's H/8 rows, bound every segment's share)
                halo = 2 * 2 * (n_used - 1) / (h // 8)
                if got["peak_mib"] > 1.2 * ref["peak_mib"] * (1 + halo):
                    bad.append(f"peak {got['peak_mib']} MiB above 1.2 x {ref['peak_mib']} MiB "
                               f"x (1 + {halo}) (halo rows)")
                if bad:
                    failures.append(f"{h}x{w} {route} {n} shards: {bad}")
    return failures, launches


def _mesh_forms(torch, params, n, side):
    """Part 1's kernel table: each of the five sharded chain kernels alone at
    the ``side`` x ``side`` scale's shapes on a mesh of ``n`` shards of the one card,
    against the unsharded kernel on the same bf16 inputs and cotangents:
    outputs, Gram and input gradient (relative Frobenius), and the
    fwd+bwd device ms of both (profiler), with the halo's share of the
    rows."""
    import numpy as np

    from style_transfer_tpu_torch.ops.kernels import block1 as B1
    from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
    from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
    from style_transfer_tpu_torch.ops.kernels import conv_single as CS
    from style_transfer_tpu_torch.ops.kernels import tolerances as T
    from style_transfer_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(devices=["cuda:0"] * n)
    bf = torch.bfloat16
    w = {k: [t.cuda() for t in (v["kernel"], v["bias"])] for k, v in params.items()}
    s1, s4 = side // 2, side // 16
    cases = {  # name: (unsharded, sharded, pool level, input shape, weights, out, halo, convs)
        "block1_packed": (B1.block1_packed, B1.make_sharded_block1(mesh), 0, (side, side, 3),
                          w["conv1_1"] + w["conv1_2"], True, CP.HALO, ((3, 64), (64, 64))),
        "conv_pair": (lambda x, *p: CP.conv_pair(x, *p, pool=True, gram=True),
                      CP.make_sharded_pair(mesh, pool=True, gram=True), 1, (s1, s1, 64),
                      w["conv2_1"] + w["conv2_2"], True, CP.HALO, ((64, 128), (128, 128))),
        "conv_single": (CS.single_gram, CS.make_sharded_single(mesh, pool=False, gram=True),
                        1, (s1, s1, 64), w["conv2_1"], True, 1, ((64, 128),)),
        "gram_tail": (CS.gram_tail, CS.make_sharded_gram_tail(mesh), 4, (s4, s4, 512),
                      w["conv5_1"], False, 1, ((512, 512),)),
        "conv_gram": (CG.conv_gram, CG.make_sharded_conv_gram(mesh), 4, (s4, s4, 512),
                      w["conv5_1"], False, 1, ((512, 512),)),
    }
    rows = {}
    r = np.random.RandomState(15)
    failures = []
    for name, (plain_fn, sharded_fn, level, shape, wts, has_out, halo, convs) in cases.items():
        x = torch.from_numpy(r.rand(1, *shape).astype(np.float32)).to(bf).cuda()
        # the side^2 image's shard rows at this pool level (the sharded time
        # includes one gather of the output, which the path does not make)
        bounds = tuple((lo >> level, hi >> level) for lo, hi in M.row_bounds(side, n))

        def run(fn, sharded, cot=None):
            xx = x.clone().requires_grad_(True)
            xs = M.scatter_rows(xx, bounds, mesh) if sharded else xx
            out, g = fn(xs, *wts) if has_out else (None, fn(xs, *wts))
            if sharded and out is not None:
                out = M.gather_rows(out, "cuda:0")
            if cot is None:
                cot = [None if out is None else torch.randn_like(out, dtype=torch.float32).to(bf),
                       torch.randn_like(g)]
            tot = (g * cot[1]).sum()
            if out is not None:
                tot = tot + (out.float() * cot[0].float()).sum()
            (dx,) = torch.autograd.grad(tot, xx)
            return out, g, dx, cot

        o1, g1, d1, cot = run(plain_fn, False)
        o2, g2, d2, _ = run(sharded_fn, True, cot)
        errs = {"gram": _rel(g2, g1), "dx": _rel(d2, d1)}
        if o1 is not None:
            errs["out"] = _rel(o2, o1)
        ms = _device_ms(torch, lambda: run(plain_fn, False, cot), reps=3)
        ms_sh = _device_ms(torch, lambda: run(sharded_fn, True, cot), reps=3)
        extra = sum(min(halo, lo) + min(halo, shape[0] - hi) for lo, hi in bounds)
        # the bound: the inputs, outputs and input gradient moved once, and the
        # convs (forward and backward-data) and both Gram products over the
        # rows each form computes (the sharded form: the halo rows as well)
        nbytes = _nbytes(x, g1, d1) + (0 if o1 is None else _nbytes(o1))
        cmid = convs[0][1]

        def bound(h):
            return _bound(nbytes, _conv_flops(h, shape[1], *convs)
                          + _gram_flops(h * shape[1], cmid), "bf16")

        rows[name] = {"shape": list(shape), "shards": len(bounds), "errors": errs,
                      "ms": ms, "sharded_ms": ms_sh, "halo_rows": extra,
                      "halo_row_share": extra / shape[0],
                      "bound_ms": bound(shape[0])[0], "sharded_bound_ms": bound(shape[0] + extra)[0],
                      "bound_by": bound(shape[0] + extra)[1]}
        lim = {"out": T.TOL_ACT, "gram": T.TOL_GRAM, "dx": T.TOL_DX}
        over = {k: v for k, v in errs.items() if v > lim[k]}
        if over:
            failures.append(f"sharded {name} departs from the unsharded kernel: {over}")
    emit({"phase": "mesh", "part": f"forms_{side}_{n}_shards", "kernels": rows,
          "tol": {"out": T.TOL_ACT, "gram": T.TOL_GRAM, "dx": T.TOL_DX}})
    return failures, rows


def _mesh_config5(torch, params, mean, std, steps, devices, n):
    """Part 3 of :func:`mesh_check`: configuration 5 through ``stylize()``
    on a mesh of ``n`` shards against the unsharded run (and, reported
    beside, both against the plain path in fp32); returns the failures."""
    import dataclasses

    import numpy as np

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.parallel import mesh as M

    r = np.random.RandomState(5)
    content = r.rand(*CONFIG5_HW, 3).astype(np.float32)
    style = r.rand(1024, 1024, 3).astype(np.float32)
    cfg = StylizeConfig(size=max(CONFIG5_HW), min_scale=CONFIG5_MIN_SCALE,
                        iterations=(steps,), chunk_size=10)
    mesh = M.make_mesh(devices=list(devices)[:n])
    st = StyleTransfer(params, mean=mean, std=std, device=mesh.home, mesh=mesh)
    forms = {}
    real_vgg = st._vgg

    def vgg(cfg_, image, cl, sl, remat=False):
        out = real_vgg(cfg_, image, cl, sl, remat)
        if cl and sl:  # the objective, not a capture
            forms[image.shape[1]] = [list(p) for p in st.last_route]
        return out

    st._vgg = vgg
    shards = {}
    with _DispatchSpy(torch, st, sync_mode="warn") as spy:
        out, curves, summary, seconds, launches = _counted_stylize_events(
            torch, st, content, style, cfg, shards)
    del st._vgg
    ref = StyleTransfer(params, mean=mean, std=std, device="cuda")
    out1, curves1, summary1, seconds1 = _stylize(torch, ref, content, style, cfg)
    st32 = StyleTransfer(params, mean=mean, std=std, device="cuda", compute_dtype=torch.float32)
    curves32 = _stylize(torch, st32, content, style, dataclasses.replace(cfg, use_fused=False))[1]

    def dev(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    syncs = [len(c) for c in spy.syncs]
    falls = {k: _falls_by_chunk_peaks(v, cfg.chunk_size) for k, v in curves.items()}
    emit({"phase": "mesh", "part": "config5", "devices": [str(d) for d in mesh.devices],
          "sizes": summary["sizes"], "shards_per_scale": shards, "forms_per_scale_rows": forms,
          "seconds": seconds, "unsharded_seconds": seconds1, "launches": launches,
          "its_per_sec_steady": summary["per_scale_its_per_sec"],
          "unsharded_its_per_sec_steady": summary1["per_scale_its_per_sec"],
          "peak_mib": summary["peak_mib"], "unsharded_peak_mib": summary1["peak_mib"],
          "loss_per_step": curves, "unsharded_loss_per_step": curves1,
          "dev_from_unsharded": {k: dev(curves[k], curves1[k]) for k in curves},
          "dev_from_plain_fp32": {k: dev(curves[k], curves32[k]) for k in curves},
          "unsharded_dev_from_plain_fp32": {k: dev(curves1[k], curves32[k]) for k in curves},
          "tol_curve": TOL_CURVE, "falls_by_chunk_peaks": falls,
          "syncs_per_chunk": syncs, "chunks": spy.queued,
          "sync_where": sorted({w for c in spy.syncs for w in c}),
          "out_shape": list(out.shape)})
    failures = []
    if any(syncs) or not syncs:
        failures.append(f"config5: synchronizing calls in Adam chunks: {syncs}")
    if not all(falls.values()):
        failures.append(f"config5: a scale's loss does not fall by chunk peaks: {falls}")
    far = {k: dev(curves[k], curves1[k]) for k in curves if dev(curves[k], curves1[k]) > TOL_CURVE}
    if far:
        failures.append(f"config5: curves depart from the unsharded run: {far}")
    if out.shape != (*CONFIG5_HW, 3) or not np.isfinite(out).all():
        failures.append("config5: output shape or values")
    if list(shards.values()) != [M.shard_count(h, n) for h, _ in summary["sizes"].values()]:
        failures.append(f"config5: shards per scale {shards}")
    return failures


def _counted_stylize_events(torch, st, content, style, cfg, shards):
    """:func:`_counted_stylize` that also keeps each scale's shard count."""
    counters = _counters()
    for c in counters.values():
        c.n = 0
    real = st.stylize

    def stylize(content, style, cfg, callback=None):
        def cb(ev):
            shards[ev.scale_index] = ev.shards
            callback(ev)

        return real(content, style, cfg, callback=cb)

    st.stylize = stylize
    try:
        out, curves, summary, seconds = _stylize(torch, st, content, style, cfg)
    finally:
        del st.stylize
    return out, curves, summary, seconds, {k: c.n for k, c in counters.items()}


def mesh_check(torch, params, mean, std, steps):
    """Phase 15: the spatial mesh (``parallel/mesh.py``) at VGG-19's full
    widths, default layers, average pooling, TV weight 2, Adam, seeded
    weights and noise; the meshes repeat the one card (``[cuda:0] * n``):

    1. 2048x2048: the objective's loss terms and image gradient with 2, 4
       and 8 shards, on the natural route (block 1, singles, ``conv_gram``)
       and on the forced one (pairs, block 2's pair, ``gram_tail``), against
       the unsharded chain on the card and the plain fp32 witness; launches
       per kernel (N times the unsharded chain's) and forward launches per
       shard (every kernel on every shard), an Adam step's wall and device
       ms and peak MiB (within 1.2x the unsharded peak grown by the halo
       rows: no full-size gather); then each of the five sharded kernels
       alone at the scale's shapes with 8 shards against the unsharded
       kernel, with both device times and the halo's share of the rows;
    2. 512x512 and 128x128 with 8 shards (block 4 at 8 and 2 rows a shard,
       conv5_1 at 4 and 1), and configuration 5's 1080x1920 scale, where
       block 4 and conv5_1 run the plain sharded VGG: the same objective
       checks;
    3. configuration 5 through ``stylize()``: a 3840x2160 noise content over
       its five scales (240 -> 3840 px wide), ``steps`` a scale in chunks of
       10, 8 shards, against the unsharded run: the curve (``TOL_CURVE``),
       falling by chunk peaks, shards per scale, the route at each scale,
       and no synchronizing call in any pipelined Adam chunk;
    4. ``parallel.dryrun.dryrun_multichip(8, [cuda:0] * 8)``, four variants;
    5. with more than one card visible, parts 1 and 3 over real devices;
       else a line says that it did not run.

    Returns, for the kernels line, each of the five sharded kernels'
    launches in an 8-shard evaluation of part 1 on the route that runs it
    and its part-1 table row."""
    from style_transfer_tpu_torch.parallel.dryrun import dryrun_multichip

    n_max = max(MESH_SHARDS)
    one = ["cuda:0"] * n_max
    failures, launches = _mesh_objectives(torch, params, mean, std, hw=(MESH_SIDE, MESH_SIDE),
                                          shards=MESH_SHARDS, routes=("natural", "forced"),
                                          devices=one, witness=True)
    forms_fail, forms = _mesh_forms(torch, params, n_max, MESH_SIDE)
    failures += forms_fail
    for hw in ((MESH_SMALL_SIDE,) * 2, (MESH_TINY_SIDE,) * 2, CONFIG5_ODD_HW):
        failures += _mesh_objectives(torch, params, mean, std, hw=hw, shards=(n_max,),
                                     routes=("natural",), devices=one, witness=True)[0]
    failures += _mesh_config5(torch, params, mean, std, steps, one, 8)
    try:
        dry = dryrun_multichip(8, one)
        emit({"phase": "mesh", "part": "dryrun_multichip", "results": dry})
    except AssertionError as e:
        failures.append(f"dryrun_multichip: {e}")
    count = torch.cuda.device_count()
    if count > 1:
        real = [f"cuda:{i}" for i in range(count)]
        n = min(8, count)
        failures += _mesh_objectives(torch, params, mean, std, hw=(MESH_SIDE, MESH_SIDE),
                                     shards=(n,),
                                     routes=("natural",), devices=real, witness=False)[0]
        failures += _mesh_config5(torch, params, mean, std, steps, real, n)
    else:
        emit({"phase": "mesh", "part": "real_devices", "ran": False,
              "note": "one CUDA device visible: parts 1 and 3 over real devices did not run"})
    if failures:
        raise AssertionError(f"mesh: {failures}")
    return {k: dict(forms[k], launches_8_shards=max(launches[(r, n_max)].get(k, 0)
                                                    for r in ("natural", "forced")))
            for k in MESH_KERNELS}


PHASES = ("kernel", "segment_forms", "parity", "stylize", "large", "fused_block1", "objective",
          "profile", "ladder", "lbfgs", "cli", "pipeline", "mesh")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all; the device and build "
                             "phases always run, the kernels line needs all)")
    parser.add_argument("--kernels", default="",
                        help="comma-separated kernel names: the kernel phase runs only their cases "
                             "(and the edge cases of the losses among them), e.g. "
                             "content_loss,style_loss,tv_loss")
    parser.add_argument("--steps", type=int, default=20,
                        help="optimizer steps per scale of the stylize phases, of lbfgs's first "
                             "part and of the cli phase's configurations (default 20)")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {PHASES}")
    only = tuple(k for k in args.kernels.split(",") if k)
    unknown = [k for k in only if k not in KERNEL_META]
    if unknown:
        parser.error(f"unknown kernels {unknown}; choose from {sorted(KERNEL_META)}")

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
    tensor_cores, missing = tensor_core_report(_build.library_path())
    emit({"phase": "build", "seconds": seconds,
          "tensor_cores": tensor_cores if tensor_cores is not None else "cuobjdump not found or failed",
          "block1_ptxas": ptxas_by_kernel(log.read_text(), "block1") if log.is_file() else {},
          "ptxas": report})
    if missing:
        raise AssertionError(f"no tensor-core op in the built kernels: {missing}")

    import numpy as np

    from style_transfer_tpu_torch import StylizeConfig
    from style_transfer_tpu_torch.ops.kernels import gram as KG

    params, mean, std = random_fixture(0)
    peak, seconds_by_phase = {}, {"build": seconds}
    summary, launches = {}, {}

    def measured(phase, fn):  # runs a phase and keeps its peak device memory and its seconds
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        seconds_by_phase[phase] = time.perf_counter() - t0
        peak[phase] = torch.cuda.max_memory_allocated() / 2**20
        return out

    def timed(phase, fn):  # the stylize phases reset the peak per scale themselves
        t0 = time.perf_counter()
        out = fn()
        seconds_by_phase[phase] = time.perf_counter() - t0
        return out

    def stylize_phase(phase, seed, hw, **kwargs):
        r = np.random.RandomState(seed)
        cfg = kwargs.pop("cfg")
        launches[phase] = timed(phase, lambda: stylize_check(
            torch, params, mean, std, phase=phase, content=r.rand(*hw, 3).astype(np.float32),
            style=r.rand(*hw, 3).astype(np.float32), cfg=cfg, **kwargs))

    steps = (args.steps,)
    opt_in = ("block1_full", "block1_tail", "pallas_gram", "content_loss", "style_loss")
    if "kernel" in phases:
        summary = measured("kernel", lambda: kernel_checks(torch, params, only))
    if "segment_forms" in phases:
        measured("segment_forms", lambda: segment_forms(torch, params))
    if "parity" in phases:
        measured("parity", lambda: parity_check(torch, params, mean, std))
    emit({"phase": "memory", "peak_mib": peak,
          "note": "the stylize phases print their peak per scale"})
    if "stylize" in phases:
        stylize_phase("stylize", 0, (512, 512),
                      cfg=StylizeConfig(size=512, min_scale=256, iterations=steps, chunk_size=10),
                      required=("block1_packed", "conv_pair", "conv_gram", "tv_loss"), absent=opt_in)
    if "large" in phases:
        stylize_phase("large", 1, (512, 8192),
                      cfg=StylizeConfig(size=(512, 8192), min_scale=2048, iterations=steps,
                                        chunk_size=10),
                      required=("block1_packed", "conv_single", "gram_tail", "conv_gram", "tv_loss"),
                      absent=("conv_pair",) + opt_in)
    if "fused_block1" in phases:
        stylize_phase("fused_block1", 2, (1024, 1024),
                      cfg=StylizeConfig(size=1024, min_scale=512, iterations=steps, chunk_size=10,
                                        fused_block1=True),
                      required=("block1_full", "tv_loss")
                      + (("pallas_gram",) if KG.KERNEL_CHANNELS else ()),
                      absent=("block1_packed", "conv_pair", "conv_single", "gram_tail", "conv_gram",
                              "block1_tail", "content_loss", "style_loss")
                      + (() if KG.KERNEL_CHANNELS else ("pallas_gram",)))
    if "objective" in phases:
        launches.update(measured("objective", lambda: objective_check(torch, params, mean, std)))
    if "profile" in phases:
        timed("profile", lambda: step_profile(torch, params, mean, std))
    if "ladder" in phases:
        timed("ladder", lambda: ladder(torch, params, mean, std))
    if "lbfgs" in phases:
        launches["lbfgs"] = timed("lbfgs", lambda: lbfgs_check(torch, params, mean, std,
                                                             args.steps))
    if "cli" in phases:
        timed("cli", lambda: cli_check(torch, args.steps))
    if "pipeline" in phases:
        timed("pipeline", lambda: pipeline_check(torch, params, mean, std, args.steps))
    mesh_forms = {}
    if "mesh" in phases:
        mesh_forms = timed("mesh", lambda: mesh_check(torch, params, mean, std, args.steps))
    emit({"phase": "memory", "peak_mib": {"objective": peak.get("objective")},
          "seconds_by_phase": seconds_by_phase})

    if all(p in phases for p in PHASES) and not only:
        emit({"kernels": [
            {"name": name, "route": "cuda",
             "source": "style_transfer_tpu_torch/" + sources[0],
             "sources": ["style_transfer_tpu_torch/" + s for s in sources],
             "replaces": replaces, "launches": launches[phase][name],
             "max_abs_err": summary[name]["max_abs_err"],
             "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"],
             "bound_ms": summary[name]["bound_ms"], "bound_by": summary[name]["bound_by"],
             "bound_two_pass_ms": summary[name]["bound_two_pass_ms"],
             "library_ms": summary[name]["library_ms"], "mesh": mesh_forms.get(name)}
            for name, (replaces, sources, phase) in KERNEL_META.items()
        ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
