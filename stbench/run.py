"""The benchmark of ``style_transfer_tpu_torch`` on one card: one run of one
cell.

    python3 stbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m stbench.run``) from the root of a checkout. Prints the
comparison's numbers beside their limits on standard error, and as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``. Exits 2 without the CUDA devices the cell asks for, and 3
if JAX or the JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: import from the checkout's root
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]
    sys.path.insert(0, str(_here.parent))

from stbench import manifest  # noqa: E402

#: Top-level module names no run may load, compared whole: the program's
#: package name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "style_transfer_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def _power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None


def _cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    library in its own package directory)."""
    base = root / ".stbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def main(argv=None, *, root: Path = manifest.ROOT, device=None, after_judge=None) -> int:
    """One run; ``after_judge(run, capture, content, style, details)``, where
    given, is called once the program's numbers are read (the control's
    readings, ``control.py``), ``details`` their raw readings per scale."""
    args = _parser().parse_args(argv)
    _cache_dirs(Path(root))
    cell = manifest.load_cell(args.workload, root)
    import torch

    from stbench import inputs
    from stbench.harness import Run
    from stbench.judge import check_lines, judge, passes

    if device is None:
        chips = int(cell.entry["chips"])
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"stbench: {args.workload} needs {chips} CUDA device(s), found {found}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)

    run = Run(cell, args.seed, args.seconds, bool(args.trace), device, _T_START)
    run.build()
    values = manifest.loop(cell.workload["loop"]).run(run)
    peak_bytes = run.data.get("peak_bytes", run.peak_bytes())
    values["peak_mib"] = peak_bytes / 2 ** 20
    values["setup_s"] = run.setup_s
    run.free_program()

    cap, index = run.checked
    run.sync()  # the capture's copies are complete
    content, style = inputs.images(args.seed, index, cell.workload["content_hw"],
                                   cell.workload["style_hw"], device)
    details = {} if after_judge is not None else None
    numbers = judge(run.arch, run.fields, cap, content, style, run.params, run.mean, run.std,
                    device, details)
    if after_judge is not None:
        after_judge(run, cap, content, style, details)
    limits = cell.workload["limits"]
    checks = check_lines(numbers, limits)
    correct = passes(numbers, limits, run.failed)

    if args.trace:
        readers = manifest.per_layer_readers(cell)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]](run.data) if readers[m["name"]] else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if run.cuda else device.type, "kind": run.kind,
           "count": int(cell.entry["chips"]) if run.cuda else 1,
           "memory_peak_bytes": peak_bytes, "power": _power_limit() if run.cuda else None}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    trace_slice = run.data.get("slice")
    if args.trace and trace_slice is not None:
        dev.update(busy_s=trace_slice["busy_s"], window_s=trace_slice["window_s"])
        result["breakdown"] = {"device_ops": trace_slice["device_ops"],
                               "idle_gaps": trace_slice["idle_gaps"]}
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"stbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
