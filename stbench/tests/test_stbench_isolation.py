"""No run loads JAX or the JAX package, compared by whole top-level names;
a run without the card's CUDA devices fails and prints no result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from stbench import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["style_transfer_tpu_torch", "style_transfer_tpu_torch.api",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["style_transfer_tpu.api", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "style_transfer_tpu"]


def test_a_whole_cpu_run_loads_no_forbidden_module(tiny_root):
    code = ("import sys, json; from pathlib import Path; from stbench import run; "
            f"rc = run.main(['--workload', 'tiny-adam', '--seed', '7', '--seconds', '0'], "
            f"root=Path({str(tiny_root)!r}), device='cpu'); "
            "print(json.dumps(run.forbidden_modules())); sys.exit(rc)")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_a_run_with_a_forbidden_module_loaded_prints_no_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    capsys.readouterr()
    rc = run.main(["--workload", "tiny-adam", "--seed", "7", "--seconds", "0"], root=tiny_root,
                  device="cpu")
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "jax" in captured.err


def test_without_the_card_a_run_fails_and_prints_no_result():
    done = subprocess.run([sys.executable, "stbench/run.py", "--workload", "adam-2048", "--seed",
                           "3000000001", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode == 2 and done.stdout == ""
    assert "needs 1 CUDA device" in done.stderr


def test_only_the_benchmarks_files_fail_to_run(tmp_path):
    """A directory holding only BENCHMARK.json and stbench/ has no program."""
    import shutil

    shutil.copytree(ROOT / "stbench", tmp_path / "stbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = subprocess.run([sys.executable, "stbench/run.py", "--workload", "adam-2048", "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    done = subprocess.run([sys.executable, "stbench/run.py", "--workload", "adam-2048", "--seed",
                           "3000000003", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
