"""The port's perf harness (``python -m style_transfer_tpu_torch.bench``) on the
CPU at 64 px: one parsable JSON record per stage with the last one complete,
``"route": "plain"`` (no kernel runs there), the cut of an overrun stage
(exit 3), a failed stage recorded (exit 1), exit 2 without CUDA and without
``--device cpu``, and the reference's closed-form FLOP count. The rate
stages and configuration 4 run at 64 px with their schedules shortened
through ``RATES`` and ``CONFIG4``; their full sizes need the card."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from style_transfer_tpu_torch import bench as B
from style_transfer_tpu_torch.ops.kernels._build import KernelBuildError

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--size", "64", "--iterations", "2", "--skip-rates"]

torch.set_num_threads(2)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_cpu_records_one_line_per_stage(capsys):
    assert B.main(SMALL) == 0
    lines = _lines(capsys)
    assert [r["stage"] for r in lines] == ["setup", "ladder", "done"]
    rec = lines[-1]
    assert set(rec) == B.expected_keys(SMALL)
    assert rec["metric"] == "wallclock_64px_multiscale" and rec["unit"] == "s"
    assert rec["value"] > 0 and rec["vs_baseline"] == pytest.approx(60.0 / rec["value"])
    assert rec["route"] == "plain" and rec["device"] == {"name": "cpu"} and rec["devices"] == 1
    assert len(rec["wallclock_runs"]) == 3 and rec["value"] == sorted(rec["wallclock_runs"])[1]
    assert rec["warm_seconds"] > 0 and rec["peak_mib_ladder"] is None
    assert list(rec["per_scale_seconds"]) == ["scale0_64x64"] and rec["errors"] == []
    assert lines[0]["value"] is None  # the headline is not known before its stage


def test_cold_flag_gives_one_timed_run(capsys):
    assert B.main(SMALL + ["--cold"]) == 0
    rec = _lines(capsys)[-1]
    assert len(rec["wallclock_runs"]) == 1 and rec["warm_seconds"] is None
    assert rec["value"] == rec["wallclock_runs"][0] > 0


def test_every_stage_at_64_px(capsys, monkeypatch):
    """The rates (Adam and L-BFGS), the ladder and configuration 4, shortened:
    each stage's keys, the host-clock rate beside the events', and no device
    number from a CPU run."""
    for tag, (_, _, _, opt) in B.RATES.items():
        monkeypatch.setitem(B.RATES, tag, (64, 4, 2, opt))
    monkeypatch.setattr(B, "CONFIG4", dict(B.CONFIG4, size=64, min_scale=32,
                                           iterations=(2, 4), chunk_size=2))
    argv = ["--device", "cpu", "--size", "64", "--iterations", "2", "--skip-4k", "--cold"]
    assert B.main(argv) == 0
    lines = _lines(capsys)
    assert [r["stage"] for r in lines] == ["setup", "rates_512", "rates_1024", "rates_1024_lbfgs",
                                           "rates_2048", "ladder", "config4", "done"]
    rec = lines[-1]
    assert set(rec) == B.expected_keys(argv)
    for tag in ("512", "1024", "1024_lbfgs", "2048"):
        assert rec[f"its_per_sec_{tag}"] > 0 and rec[f"its_per_sec_{tag}_event"] > 0
        assert rec[f"its_per_sec_{tag}_chunks"] == 1
        assert rec[f"device_busy_{tag}"] is None and rec[f"peak_mib_{tag}"] is None
    assert rec["model_tflops_per_it_512"] == B.model_tflops_per_iter(64)
    assert rec["achieved_tflops_512"] is None and rec["mfu_512"] is None
    assert "mfu_1024_lbfgs" not in rec
    assert rec["lbfgs_1024_iters_to_stop"] in (2, 4) and rec["lbfgs_1024_final_loss"] > 0


def test_quick_headline_is_the_512_rate(capsys, monkeypatch):
    monkeypatch.setitem(B.RATES, "512", (64, 4, 2, "adam"))
    assert B.main(["--device", "cpu", "--quick"]) == 0
    rec = _lines(capsys)[-1]
    assert rec["metric"] == "its_per_sec_512px" and rec["unit"] == "it/s"
    assert rec["value"] == rec["its_per_sec_512"] > 0
    assert set(rec) == B.expected_keys(["--quick"])


def test_failed_stage_is_recorded_and_the_run_goes_on(capsys, monkeypatch):
    monkeypatch.setattr(B, "CONFIG4", dict(B.CONFIG4, size=64, min_scale=64, iterations=(2,),
                                           chunk_size=2))

    def boom(self):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(B._Bench, "ladder", boom)
    monkeypatch.setattr(B, "stages", lambda args: ["setup", "ladder", "config4"])
    assert B.main(SMALL[:-1]) == 1
    lines = _lines(capsys)
    assert [r["stage"] for r in lines] == ["setup", "ladder", "config4", "done"]
    rec = lines[-1]
    assert rec["errors"] == [{"label": "ladder", "error_kind": "oom",
                              "detail": "OutOfMemoryError: CUDA out of memory. Tried to "
                                        "allocate 2.00 GiB"}]
    assert rec["value"] is None and rec["lbfgs_1024_final_loss"] > 0


def test_model_tflops_equal_the_reference():
    spec = importlib.util.spec_from_file_location("reference_bench", REPO / "bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for size in (256, 512, 1024, 2048, 4096):
        assert B.model_tflops_per_iter(size) == ref.model_tflops_per_iter(size)


@pytest.mark.parametrize("exc, kind", [
    (torch.cuda.OutOfMemoryError("\x1b[31mCUDA out of memory\x1b[0m"), "oom"),
    (KernelBuildError("nvcc failed: \x1b[1mconv3x3.cu\x1b[0m"), "build"),
    (RuntimeError("\x1b[2mnoise\x1b[0m"), "error"),
])
def test_error_record_classifies_and_strips_ansi(exc, kind):
    rec = B._error_record("ladder", exc)
    assert rec["label"] == "ladder" and rec["error_kind"] == kind
    assert "\x1b" not in rec["detail"] and rec["detail"].startswith(type(exc).__name__)


def test_budget_overrun_exits_3_with_a_cut_record():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "style_transfer_tpu_torch.bench", *SMALL,
                           "--budget-s", "0.01"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert lines and lines[-1]["cut"] == lines[-1]["stage"] in B.stages(B._args(SMALL))
    assert "budget" in proc.stderr


def test_no_cuda_without_device_cpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert B.main(["--quick"]) == 2
    assert "--device cpu" in capsys.readouterr().err
