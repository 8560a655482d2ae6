"""The library walkthrough (``python -m style_transfer_tpu_torch.examples.stylize``)
on the CPU at 64 px on the port's fixture: it writes a PNG of the right
shape, and without CUDA and without ``--device cpu`` it exits 2."""

import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_tpu_torch.examples import stylize as EX

torch.set_num_threads(2)


def _png(path, h, w, seed):
    Image.fromarray((np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)).save(path)


def test_example_runs_on_the_cpu(tmp_path, capsys):
    _png(tmp_path / "c.png", 64, 48, 0)
    _png(tmp_path / "s1.png", 40, 40, 1)
    _png(tmp_path / "s2.png", 32, 48, 2)
    out = tmp_path / "out.png"
    assert EX.main([str(tmp_path / "c.png"), str(tmp_path / "s1.png"), str(tmp_path / "s2.png"),
                    "--device", "cpu", "--size", "64", "--iterations", "2",
                    "-o", str(out)]) == 0
    assert "random fixture" in capsys.readouterr().out
    with Image.open(out) as im:
        assert im.size == (48, 64) and im.mode == "RGB"


def test_example_without_cuda_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert EX.main(["c.png", "s.png"]) == 2
    assert "--device cpu" in capsys.readouterr().err
