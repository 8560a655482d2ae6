"""The kernel validator's command line on the CPU: one JSON record per
(kernel, size) with ``"route": "plain"`` (every wrapper runs its plain
version there, so no record reads as a kernel check), and exit code 2 when
CUDA is absent and ``--device cpu`` was not asked for."""

import json

import pytest
import torch

from style_transfer_tpu_torch.ops.kernels import tolerances as T
from style_transfer_tpu_torch.scripts import validate_kernels as VK

KEYS = {"kernel", "size", "shape", "route", "value_rel", "grad_rel", "ok", "kernel_ms",
        "plain_ms", "library_ms"}


def _records(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_cpu_record_contract(capsys):
    assert VK.main(["--device", "cpu", "--sizes", "64", "--repeats", "0", "--blocks", "b2"]) == 0
    out = capsys.readouterr()
    (rec,) = _records(out.out)
    assert KEYS <= set(rec)
    assert rec["kernel"] == "block2" and rec["size"] == 64 and rec["shape"] == [1, 32, 32, 64]
    assert rec["route"] == "plain" and rec["ok"] is True
    assert rec["kernel_ms"] is rec["plain_ms"] is rec["library_ms"] is None
    assert 0 < rec["value_rel"] <= T.TOL_ACT and 0 < rec["grad_rel"] <= T.TOL_DX
    assert [e["tol"] for e in rec["errors"]] == [T.TOL_ACT, T.TOL_GRAM, T.TOL_DX]
    assert "ALL OK" in out.err


def test_timed_record_and_odd_extent_skip(capsys):
    assert VK.main(["--device", "cpu", "--sizes", "64", "--height", "40", "--repeats", "1",
                    "--blocks", "b4", "b2"]) == 0
    skipped, timed = _records(capsys.readouterr().out)
    assert skipped["shape"] == [1, 5, 8, 512] and skipped["ok"] and "skipped" in skipped
    assert timed["kernel"] == "block2" and timed["shape"] == [1, 20, 32, 64] and timed["ok"]
    assert all(timed[k] > 0 for k in ("kernel_ms", "plain_ms", "library_ms"))


def test_no_cuda_without_device_cpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert VK.main(["--sizes", "64", "--repeats", "0"]) == 2
    assert "--device cpu" in capsys.readouterr().err
