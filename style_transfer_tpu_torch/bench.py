"""Perf harness of the PyTorch port: the twin of the JAX package's ``bench.py``.

    python -m style_transfer_tpu_torch.bench            # every stage, on the card
    python -m style_transfer_tpu_torch.bench --quick    # the 512 px rate only
    python -m style_transfer_tpu_torch.bench --device cpu --size 64 --iterations 2 --skip-rates

The flags, stages, schedules and inputs are the reference's (``bench.py``):
seeded uint8 content (2048^2) and style (1024^2) images, the port's seeded
fixture weights, Adam at lr 0.05, then

- rates: 512 px (120 iterations in chunks of 15), 1024 px (120 / 15),
  L-BFGS at 1024 px (80 / 10), 2048 px (60 / 10) and 4096 px (125 / 25,
  not under ``--skip-4k``), the first chunk of each dropped;
- the ``--size`` ladder (``min_scale`` 256, chunks of 25, ``stop_tol``
  2e-3, patience 2, uint8 output), warmed once with every distinct chunk
  length of each scale (``schedule.chunk_lengths``: on the card the warm
  pass takes the kernel build, the weight cache's preparations and the
  allocator's growth out of the timed runs), then timed three times; the
  median is the headline (``--cold``: one run, no warm pass);
- the 4096 px ladder ``(150, 100, 75, 50, 50)`` when ``--size`` is 2048,
  warmed and timed the same way;
- configuration 4's convergence (L-BFGS, memory 10, TV weight 8, 256 ->
  1024 px, ``stop_tol`` 1e-3, patience 3, up to 1000 iterations a scale):
  the final scale's last loss and its iterations to the stop.

``--quick`` runs the 512 px rate alone; ``--skip-rates`` skips the rates and
configuration 4. ``--unfused`` runs the plain path (``use_fused=False``: cuDNN
on the card), the one plain route the port has.

**Rates.** ``its_per_sec_<n>`` is taken on the host's clock: the steady
iterations over the wall time from the end of the first chunk (its event is
waited for once) to the end of the run, the card synchronized. Below 1024
px the host sets the pace, so the events' rates, which are timed on the
card's clock since the pipelined chunk loop (``api.py``), would read the
device's speed and not the user's. Their median goes beside it as
``its_per_sec_<n>_event``, their largest as ``_max``, their count as
``_chunks``. ``model_tflops_per_it_<n>`` is the reference's closed-form
count (:func:`model_tflops_per_iter`), ``achieved_tflops_<n>`` the headline
rate times it, and ``mfu_<n>`` that in percent of the H100 SXM's dense
bf16 peak (:data:`H100_SXM_BF16_PEAK_TFLOPS`). L-BFGS has no MFU: one of its
iterations runs a data-dependent number of objective evaluations.
``device_busy_<n>`` is the card's busy share over one more steady chunk run
after the timed run under ``torch.profiler`` (which slows the host, so a
host-bound share reads low): the union of the device's kernel and copy
intervals within the chunk's span, over that span. ``peak_mib_<n>`` is
``torch.cuda.max_memory_allocated`` of the stage. On the CPU every device
number is ``None`` and the record says ``"route": "plain"``: the kernel
wrappers run their plain versions there, so nothing in it measures a kernel.

**Records.** After each stage stdout gets one JSON line, the record so far
with ``metric``, ``value``, ``unit``, ``vs_baseline`` (the headline and,
until it is measured, ``None``) and ``"stage"``; the last line is the
complete record. The headline is ``wallclock_<size>px_multiscale`` in
seconds (``vs_baseline`` = 60 / wall: the 60 s target of
``BASELINE.json:5``, which names no chip), or ``its_per_sec_512px`` under
``--quick``. Progress goes to stderr. A stage that raises is written into
``errors`` (:func:`_error_record`) and the run goes on; it then exits 1.
A watchdog thread cuts a stage that runs past ``--budget-s``: it prints the
record so far with ``"cut": "<stage>"`` and exits 3 (a hung CUDA call cannot
be cancelled). The default budget, :data:`DEFAULT_BUDGET_S`, is 600 s. On
an H100 (700 W) the longest stage of the full run, the 4096 px ladder, took
32.5 s, and the kernel build, which lands in the first stage of a fresh
checkout, 19.5 s (PERF.md): a margin of 18x over the longest stage.
Without CUDA and without ``--device cpu`` it exits 2.

There is no fallback: no mesh (one card), no retry of a failed
configuration, no swap of the kernel chain for the plain path.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback

#: Dense bf16 peak of one H100 SXM in TFLOP/s (NVIDIA's data sheet, 700 W):
#: the denominator of ``mfu_<n>``.
H100_SXM_BF16_PEAK_TFLOPS = 989.0

#: Seconds a stage may take unless ``--budget-s`` says otherwise.
DEFAULT_BUDGET_S = 600.0

#: Rate stages: key tag -> (size, iterations, chunk size, optimizer).
RATES = {
    "512": (512, 120, 15, "adam"),
    "1024": (1024, 120, 15, "adam"),
    "1024_lbfgs": (1024, 80, 10, "lbfgs"),
    "2048": (2048, 60, 10, "adam"),
    "4096": (4096, 125, 25, "adam"),
}

#: The 4096 px ladder's iterations per scale (256 -> 4096).
LADDER_4K = (150, 100, 75, 50, 50)

#: Configuration 4's convergence run (``configs/config4_lbfgs_tv_1024.toml``
#: with the reference bench's 1000 iterations a scale), without its optimizer.
CONFIG4 = dict(size=1024, min_scale=256, iterations=(1000, 1000, 1000), chunk_size=10,
               stop_tol=1e-3, stop_patience=3, tv_weight=8.0)

#: Keys of every record line.
BASE_KEYS = ("metric", "value", "unit", "vs_baseline", "stage", "errors", "stage_seconds",
             "device", "route", "backend", "devices", "fused", "io_dtype", "torch", "cuda",
             "peak_bf16_tflops", "budget_s")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _strip_ansi(s: str) -> str:
    return re.sub(r"\x1b\[[0-9;]*m", "", s)


def _error_record(label: str, e: BaseException) -> dict:
    """A failed stage for the record: ANSI codes stripped, and classified as
    ``oom`` (``torch.cuda.OutOfMemoryError``), ``build`` (the kernels did not
    build or load) or ``error``."""
    import torch

    from style_transfer_tpu_torch.ops.kernels._build import KernelBuildError

    msg = _strip_ansi(f"{type(e).__name__}: {e}")
    if isinstance(e, torch.cuda.OutOfMemoryError):
        kind = "oom"
    elif isinstance(e, KernelBuildError):
        kind = "build"
    else:
        kind = "error"
    return {"label": label, "error_kind": kind, "detail": msg[:300]}


def model_tflops_per_iter(size: int) -> float:
    """Closed-form model FLOPs of ONE optimizer iteration at a square
    ``size`` image with the default Gatys objective (content conv4_2, style
    conv1_1..conv5_1): VGG-19 forward to conv5_1, the frozen-weight backward
    (input gradients only, the same conv work transposed) and the style
    Grams with their backward products. Pointwise work (ReLU, pool, TV,
    Adam) is left out. The reference's count (``bench.py:58-82``), kept here
    so that the port imports nothing of it."""
    blocks = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 1)]  # to conv5_1
    conv = 0.0
    h = w = size
    cin = 3
    for bi, (c, n) in enumerate(blocks):
        for _ in range(n):
            conv += 2.0 * h * w * c * 9 * cin
            cin = c
        if bi < len(blocks) - 1:
            h //= 2
            w //= 2
    gram = 0.0
    for bi, c in enumerate([64, 128, 256, 512, 512]):
        hw = (size // (2 ** bi)) ** 2
        gram += 2.0 * hw * c * c  # forward syrk; backward F @ S costs the same
    return (2.0 * conv + 2.0 * gram) / 1e12


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="style_transfer_tpu_torch perf harness")
    p.add_argument("--size", type=int, default=2048, help="final long side of the ladder")
    p.add_argument("--iterations", type=int, nargs="+", default=[250, 200, 150, 100])
    p.add_argument("--quick", action="store_true", help="the 512 px rate only")
    p.add_argument("--unfused", action="store_true",
                   help="the plain path (use_fused=False) instead of the kernel chain")
    p.add_argument("--skip-rates", action="store_true",
                   help="skip the rates and configuration 4's convergence run")
    p.add_argument("--skip-4k", action="store_true",
                   help="skip the 4096 px rate and the 4096 px ladder")
    p.add_argument("--cold", action="store_true",
                   help="no warm pass, one timed ladder run (the kernel build and the weight "
                        "cache's preparations then land inside it)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the NVIDIA GPU (default) or the CPU, where every kernel wrapper runs "
                        "its plain version (the record says route plain)")
    p.add_argument("--budget-s", type=float, default=DEFAULT_BUDGET_S,
                   help="seconds each stage may take before the run is cut with exit code 3 "
                        f"(default {DEFAULT_BUDGET_S:g})")
    return p


def _args(argv):
    args = _parser().parse_args(argv)
    if args.quick:
        args.skip_rates = False  # --quick IS the 512 px rate
    return args


def stages(args) -> list:
    """The stages that ``args`` runs, in order."""
    if args.quick:
        return ["setup", "rates_512"]
    rates = [] if args.skip_rates else [
        f"rates_{tag}" for tag in RATES if tag != "4096" or not args.skip_4k]
    return (["setup"] + rates + ["ladder"]
            + (["ladder_4k"] if not args.skip_4k and args.size == 2048 else [])
            + ([] if args.skip_rates else ["config4"]))


def stage_keys(stage: str, size: int) -> tuple:
    """The keys a stage adds to the record."""
    if stage.startswith("rates_"):
        tag = stage[len("rates_"):]
        keys = tuple(f"{k}_{tag}" for k in ("its_per_sec", "device_busy", "peak_mib")) + tuple(
            f"its_per_sec_{tag}_{k}" for k in ("event", "max", "chunks"))
        if RATES[tag][3] == "adam":
            keys += tuple(f"{k}_{tag}" for k in ("model_tflops_per_it", "achieved_tflops", "mfu"))
        return keys
    if stage == "ladder":
        return (f"wallclock_{size}px_multiscale", "wallclock_runs", "wallclock_min",
                "per_scale_seconds", "warm_seconds", "peak_mib_ladder")
    if stage == "ladder_4k":
        return ("wallclock_4096px_multiscale", "wallclock_4096_runs", "per_scale_seconds_4096",
                "iterations_4096", "warm_seconds_4096", "peak_mib_ladder_4096")
    if stage == "config4":
        return ("lbfgs_1024_final_loss", "lbfgs_1024_iters_to_stop", "lbfgs_1024_stop_tol",
                "lbfgs_1024_seconds")
    return ()


def expected_keys(argv=None) -> set:
    """Every key of the complete record of a run with these arguments."""
    args = _args(argv)
    keys = set(BASE_KEYS)
    for stage in stages(args):
        keys.update(stage_keys(stage, args.size))
    return keys


class _Record:
    """The record so far; one lock guards it and stdout, which the watchdog
    shares with the main thread."""

    def __init__(self, metric: str, unit: str):
        self.lock = threading.Lock()
        self.data = {"metric": metric, "value": None, "unit": unit, "vs_baseline": None,
                     "stage": None, "errors": [], "stage_seconds": {}}

    def update(self, **kw) -> None:
        with self.lock:
            self.data.update(kw)

    def emit(self, **kw) -> None:
        with self.lock:
            sys.stdout.write(json.dumps({**self.data, **kw}) + "\n")
            sys.stdout.flush()


class _Watchdog:
    """Cuts the run when a stage outlasts its budget: prints the record so
    far with ``"cut"`` and ends the process with exit code 3."""

    def __init__(self, record: _Record, budget_s: float):
        self.record, self.budget_s = record, budget_s
        self.stage, self.t0 = None, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="bench-watchdog", daemon=True)
        self._thread.start()

    def begin(self, stage) -> None:
        with self.record.lock:
            self.stage, self.t0 = stage, time.monotonic()

    def _watch(self) -> None:
        poll = min(1.0, max(0.005, self.budget_s / 4))
        while not self._stop.wait(poll):
            with self.record.lock:
                stage, t0 = self.stage, self.t0
            if stage is not None and time.monotonic() - t0 > self.budget_s:
                self.record.emit(stage=stage, cut=stage)
                log(f"bench: stage {stage} ran past its budget of {self.budget_s:g} s: cut")
                os._exit(3)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"name": "cpu"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        card = f"nvidia-smi failed: {e}"
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": card}


def _busy_share(torch, prof, label: str):
    """The union of the device's intervals inside the span of the CPU range
    ``label``, over that span; ``None`` if the trace holds no device event."""
    cuda_type = torch.autograd.DeviceType.CUDA
    events = prof.events()
    span = [e for e in events if e.name == label and e.device_type != cuda_type]
    if not span:
        return None
    r0, r1 = span[0].time_range.start, span[0].time_range.end
    # the range's own GPU annotation spans it whole, and the program's spans
    # inside it (``trace.py``) each theirs: not device work
    intervals = sorted((max(e.time_range.start, r0), min(e.time_range.end, r1))
                       for e in events if e.device_type == cuda_type and e.name != label
                       and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, r0
    for s, t in intervals:
        s = max(s, end)
        if t > s:
            busy += t - s
            end = t
    return busy / (r1 - r0) if busy > 0 and r1 > r0 else None


class _Bench:
    def __init__(self, args, torch):
        self.args, self.torch = args, torch
        self.device = torch.device(args.device)
        self.cuda = self.device.type == "cuda"
        self.fused = not args.unfused
        metric, unit = (("its_per_sec_512px", "it/s") if args.quick
                        else (f"wallclock_{args.size}px_multiscale", "s"))
        self.record = _Record(metric, unit)
        self.record.update(
            route="cuda" if self.cuda and self.fused else "plain", backend=self.device.type,
            devices=1, fused=self.fused, io_dtype="uint8", torch=torch.__version__,
            cuda=torch.version.cuda, peak_bf16_tflops=H100_SXM_BF16_PEAK_TFLOPS,
            budget_s=args.budget_s, device=None)
        self.failed = False

    # ------------------------------------------------------------- helpers

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _cfg(self, **kw):
        from style_transfer_tpu_torch.api import StylizeConfig
        from style_transfer_tpu_torch.optim import OptimizerSpec

        kw.setdefault("optimizer", OptimizerSpec("adam", learning_rate=0.05))
        return StylizeConfig(use_fused=self.fused, **kw)

    def _stage(self, name: str, fn) -> bool:
        """Runs one stage under the watchdog, records a failure, prints the
        record; True if it ran through."""
        self.watchdog.begin(name)
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ok = True
        try:
            fn()
        except Exception as e:  # a failed stage is a result: record it, run the next
            ok, self.failed = False, True
            rec = _error_record(name, e)
            log(f"bench: stage {name} failed [{rec['error_kind']}]\n{traceback.format_exc()}")
            with self.record.lock:
                self.record.data["errors"].append(rec)
            if self.cuda:
                self.torch.cuda.empty_cache()
        seconds = time.perf_counter() - t0
        self.watchdog.begin(None)
        with self.record.lock:
            self.record.data["stage_seconds"][name] = seconds
        self.record.emit(stage=name)
        return ok

    def _peak_mib(self):
        return self.torch.cuda.max_memory_allocated() / 2**20 if self.cuda else None

    @contextlib.contextmanager
    def _with_dispatch(self, wrap):
        """``StyleTransfer._dispatch_chunk`` wrapped by ``wrap(real)`` inside
        the block; the card synchronized on the way out."""
        self.st._dispatch_chunk = wrap(self.st._dispatch_chunk)
        try:
            yield
        finally:
            del self.st._dispatch_chunk
            self._sync()

    # -------------------------------------------------------------- stages

    def setup(self) -> None:
        import numpy as np

        from style_transfer_tpu_torch.api import StyleTransfer

        self.record.update(device=_device_info(self.torch, self.device))
        self.st = StyleTransfer(device=self.device)  # fixture weights: time is value-independent
        r = np.random.RandomState(0)
        self.content = (r.rand(2048, 2048, 3) * 255).astype(np.uint8)
        self.style = (r.rand(1024, 1024, 3) * 255).astype(np.uint8)
        log(f"bench: device={self.record.data['device']} fused={self.fused}")

    def rate(self, tag: str) -> None:
        from style_transfer_tpu_torch.optim import OptimizerSpec

        size, iters, chunk, opt = RATES[tag]
        spec = (OptimizerSpec("lbfgs") if opt == "lbfgs"
                else OptimizerSpec("adam", learning_rate=0.05))
        cfg = self._cfg(size=size, min_scale=size, iterations=(iters,), chunk_size=chunk,
                        optimizer=spec)
        t_start = time.perf_counter()
        events, mark = [], {}

        def first_chunk_end(real):
            def dispatch(*a, **kw):
                rec = real(*a, **kw)
                if not mark:  # the end of the first chunk, waited for once
                    rec.event.synchronize()
                    mark["t"], mark["n"] = time.perf_counter(), rec.n
                return rec
            return dispatch

        with self._with_dispatch(first_chunk_end):
            self.st.stylize(self.content, self.style, cfg,
                            callback=lambda ev: events.append(ev.its_per_sec))
        t_end = time.perf_counter()
        steady = events[1:] or events
        its = (iters - mark["n"]) / (t_end - mark["t"])
        out = {f"its_per_sec_{tag}": its,
               f"its_per_sec_{tag}_event": statistics.median(steady),
               f"its_per_sec_{tag}_max": max(steady),
               f"its_per_sec_{tag}_chunks": len(steady),
               f"device_busy_{tag}": self._busy(cfg)}
        if opt == "adam":
            per_it = model_tflops_per_iter(size)
            achieved = its * per_it if self.cuda else None
            out.update({f"model_tflops_per_it_{tag}": per_it,
                        f"achieved_tflops_{tag}": achieved,
                        f"mfu_{tag}": (None if achieved is None
                                       else 100.0 * achieved / H100_SXM_BF16_PEAK_TFLOPS)})
        out[f"peak_mib_{tag}"] = self._peak_mib()
        self.record.update(**out)
        if tag == "512" and self.args.quick:
            self.record.update(value=its, vs_baseline=1.0)
        log(f"bench: {tag}: {its:.2f} it/s on the host's clock, "
            f"{out[f'its_per_sec_{tag}_event']:.2f} by events, mfu {out.get(f'mfu_{tag}')}, "
            f"busy {out[f'device_busy_{tag}']} ({time.perf_counter() - t_start:.1f} s)")

    def _busy(self, cfg):
        """``device_busy``: one steady chunk, after the timed run, under the
        profiler (module docstring); up to three traces, as one now and then
        comes back without device events."""
        if not self.cuda:
            return None
        from torch.profiler import ProfilerActivity, profile, record_function

        torch, label = self.torch, "bench_steady_chunk"
        run_cfg = dataclasses.replace(cfg, iterations=(2 * cfg.chunk_size,))
        for _ in range(3):
            seen, box = [], {}

            def profiled_second(real):
                def dispatch(*a, **kw):
                    seen.append(1)
                    if len(seen) != 2:
                        return real(*a, **kw)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        with record_function(label):
                            rec = real(*a, **kw)
                            rec.event.synchronize()
                    box["prof"] = prof
                    return rec
                return dispatch

            with self._with_dispatch(profiled_second):
                self.st.stylize(self.content, self.style, run_cfg)
            share = _busy_share(torch, box["prof"], label)
            if share is not None:
                return share
        raise RuntimeError("the profiler recorded no device time in three traces")

    def _warm(self, cfg) -> float:
        from style_transfer_tpu_torch.schedule import chunk_lengths

        warm_cfg = dataclasses.replace(
            cfg, stop_tol=0.0,
            iterations=tuple(sum(set(chunk_lengths(i, cfg.chunk_size))) for i in cfg.iterations))
        self._sync()
        t0 = time.perf_counter()
        self.st.stylize(self.content, self.style, warm_cfg, output_dtype="uint8")
        self._sync()
        return time.perf_counter() - t0

    def _timed_ladder(self, cfg, label: str):
        scale_seconds: dict = {}
        last = [0.0]

        def scale_cb(ev):
            now = time.perf_counter()
            key = f"scale{ev.scale_index}_{ev.size[0]}x{ev.size[1]}"
            scale_seconds[key] = scale_seconds.get(key, 0.0) + (now - last[0])
            last[0] = now

        self._sync()
        t0 = last[0] = time.perf_counter()
        self.st.stylize(self.content, self.style, cfg, callback=scale_cb, output_dtype="uint8")
        self._sync()
        wall = time.perf_counter() - t0
        log(f"bench: {label}: {wall:.2f} s {scale_seconds}")
        return wall, scale_seconds

    def _ladder(self, cfg, label: str):
        """``(median wall, all walls, the median run's per-scale seconds,
        warm seconds)``."""
        warm = None if self.args.cold else self._warm(cfg)
        runs = [self._timed_ladder(cfg, f"{label} run {i + 1}")
                for i in range(1 if self.args.cold else 3)]
        walls = [w for w, _ in runs]
        wall = statistics.median(walls)
        scales = min(runs, key=lambda r: abs(r[0] - wall))[1]
        return wall, walls, scales, warm

    def ladder(self) -> None:
        a = self.args
        cfg = self._cfg(size=a.size, min_scale=256, iterations=tuple(a.iterations),
                        chunk_size=25, stop_tol=2e-3, stop_patience=2)
        wall, walls, scales, warm = self._ladder(cfg, f"{a.size} px ladder")
        self.record.update(**{f"wallclock_{a.size}px_multiscale": wall, "wallclock_runs": walls,
                              "wallclock_min": min(walls), "per_scale_seconds": scales,
                              "warm_seconds": warm, "peak_mib_ladder": self._peak_mib()},
                           value=wall, vs_baseline=60.0 / wall)

    def ladder_4k(self) -> None:
        cfg = self._cfg(size=4096, min_scale=256, iterations=LADDER_4K, chunk_size=25,
                        stop_tol=2e-3, stop_patience=2)
        wall, walls, scales, warm = self._ladder(cfg, "4096 px ladder")
        self.record.update(wallclock_4096px_multiscale=wall, wallclock_4096_runs=walls,
                           per_scale_seconds_4096=scales, iterations_4096=list(LADDER_4K),
                           warm_seconds_4096=warm, peak_mib_ladder_4096=self._peak_mib())

    def config4(self) -> None:
        from style_transfer_tpu_torch.optim import OptimizerSpec

        cfg = self._cfg(optimizer=OptimizerSpec("lbfgs", memory_size=10), **CONFIG4)
        final = {}

        def cb(ev):
            if ev.scale_index == ev.num_scales - 1:
                final["loss"], final["iters"] = ev.loss, ev.iteration

        t0 = time.perf_counter()
        self.st.stylize(self.content, self.style, cfg, callback=cb)
        seconds = time.perf_counter() - t0
        self.record.update(lbfgs_1024_final_loss=final["loss"],
                           lbfgs_1024_iters_to_stop=final["iters"],
                           lbfgs_1024_stop_tol=cfg.stop_tol, lbfgs_1024_seconds=seconds)
        log(f"bench: configuration 4: final loss {final['loss']:.6g} after {final['iters']} "
            f"iterations at 1024 px ({seconds:.1f} s)")

    # ---------------------------------------------------------------- run

    def run(self) -> int:
        self.watchdog = _Watchdog(self.record, self.args.budget_s)
        try:
            for stage in stages(self.args):
                if stage == "setup":
                    fn = self.setup
                elif stage.startswith("rates_"):
                    fn = lambda tag=stage[len("rates_"):]: self.rate(tag)  # noqa: E731
                else:
                    fn = getattr(self, stage)
                if not self._stage(stage, fn) and stage == "setup":
                    break  # nothing to measure without the model
        finally:
            self.watchdog.close()
        self.record.emit(stage="done")
        return 1 if self.failed else 0


def main(argv=None) -> int:
    args = _args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("bench: CUDA is not available; pass --device cpu to run the plain versions on the "
            "CPU")
        return 2
    return _Bench(args, torch).run()


if __name__ == "__main__":
    sys.exit(main())
