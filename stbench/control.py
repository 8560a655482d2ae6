"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 stbench/control.py --workload <cell> --program-seeds 1 2 3 --seconds 51
    python3 stbench/control.py --workload <cell> --program-seeds 4 5 6 --seconds 51 --control
    python3 stbench/control.py --workload <cell> --fault half_rows --program-seeds 7 8 9

``--program-seeds``: whole runs of the cell (``run.main``) in this one
process, each printing its result line with the numbers compared; with
``--fault``, under that fault planted in the program
(:mod:`stbench.faults`). With ``--control``, each run also prints one JSON
line with the control's numbers: the reference put in the program's place
for each scale's last chunk, from the program's own state at its start,
computed in float8 e4m3 (the precision below the chain's bfloat16) and
judged by the float32 reference; and both sides' raw readings per scale.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: import from the checkout's root
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]
    sys.path.insert(0, str(_here.parent))

from stbench import faults, manifest  # noqa: E402


def control_numbers(run, capture, content, style, details: dict = None) -> dict:
    """The control's numbers in place of the program of ``run``, whose call
    made ``capture``."""
    from stbench.judge import control_capture, judge
    from stbench.reference.objective import fp8

    cap = control_capture(run.arch, capture, run.fields, content, style, run.params, run.mean,
                          run.std, run.device, fp8)
    return judge(run.arch, run.fields, cap, content, style, run.params, run.mean, run.std,
                 run.device, details)


def main(argv=None, *, root: Path = manifest.ROOT, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=faults.NAMES)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    from stbench import run

    cell = manifest.load_cell(args.workload, root)
    chunk = int(cell.stylize()["chunk_size"])
    for seed in args.program_seeds:
        def control(r, capture, content, style, details):
            ctl_details = {}
            numbers = control_numbers(r, capture, content, style, ctl_details)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                              "limits": cell.workload["limits"], "program_details": details,
                              "control_details": ctl_details}), flush=True)

        with faults.plant(args.fault, chunk) if args.fault else contextlib.nullcontext():
            rc = run.main(["--workload", args.workload, "--seed", str(seed), "--seconds",
                           str(args.seconds)], root=root, device=device,
                          after_judge=control if args.control else None)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
