"""The port stands alone: it imports no JAX, its chip check refuses to run
without a GPU, and nothing lets a CUDA tensor fall back to a plain version."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from style_transfer_tpu_torch.ops.kernels import _build
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.ops.kernels import gram as KG

REPO = Path(__file__).resolve().parents[1]
MODULES = [
    "style_transfer_tpu_torch",
    "style_transfer_tpu_torch.__main__",
    "style_transfer_tpu_torch.api",
    "style_transfer_tpu_torch.cli",
    "style_transfer_tpu_torch.linesearch",
    "style_transfer_tpu_torch.optim",
    "style_transfer_tpu_torch.schedule",
    "style_transfer_tpu_torch.models.vgg",
    "style_transfer_tpu_torch.models.weights",
    "style_transfer_tpu_torch.ops.losses",
    "style_transfer_tpu_torch.ops.kernels._build",
    "style_transfer_tpu_torch.ops.kernels._launch",
    "style_transfer_tpu_torch.ops.kernels.block1",
    "style_transfer_tpu_torch.ops.kernels.block2",
    "style_transfer_tpu_torch.ops.kernels.conv_gram",
    "style_transfer_tpu_torch.ops.kernels.conv_pair",
    "style_transfer_tpu_torch.ops.kernels.conv_single",
    "style_transfer_tpu_torch.ops.kernels.dispatch",
    "style_transfer_tpu_torch.ops.kernels.epilogue",
    "style_transfer_tpu_torch.ops.kernels.gram",
    "style_transfer_tpu_torch.ops.kernels.tolerances",
    "style_transfer_tpu_torch.parallel",
    "style_transfer_tpu_torch.parallel.dryrun",
    "style_transfer_tpu_torch.parallel.mesh",
    "style_transfer_tpu_torch.utils.ckpt",
    "style_transfer_tpu_torch.utils.imgio",
    "style_transfer_tpu_torch.utils.progress",
    "style_transfer_tpu_torch.utils.snapshots",
    "style_transfer_tpu_torch.web",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'style_transfer_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_fast_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    """Without the rest of the repo the script cannot run and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_loader_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(_build.KernelBuildError, match="CUDA is not available"):
        _build.library()


def test_missing_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_build_is_keyed_on_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert {p.name for p in _build._sources()} == {
        "block1.cu", "conv3x3.cu", "epilogue.cu", "gram.cu", "tv.cu"}
    assert _build._digest() in path.name


WRAPPERS = [
    (B1.block1_packed, 3, 4, B1.launches),
    (B2.block2_fused, 64, 4, CP.launches),
    (CP.pair_pool, 8, 4, CP.launches),
    (CG.conv_gram, 8, 2, CG.launches),
    (EP.tv_loss, 3, 0, EP.launches),
    (CS.single_gram, 64, 2, CS.launches),
    (CS.single_pool, 8, 2, CS.launches),
    (CS.gram_tail, 64, 2, CS.gram_tail_launches),
    (CS.make_pair_of_singles(pool=True, gram=True), 64, 4, CS.launches),
    (CS.make_wide_single(pool=True, gram=True, slices=2), 8, 2, CS.launches),
    (B1.block1_full, 3, 4, B1.full_launches),
]

# the wrappers that take no conv weights: (fn, input shapes, counter)
LOSS_WRAPPERS = [
    (B1.block1_tail, [(1, 8, 8, 64), (3, 3, 64, 64), (64,)], B1.tail_launches),
    (KG.pallas_gram, [(1, 8, 8, 64)], KG.launches),
    (EP.content_loss, [(1, 8, 8, 64), (1, 8, 8, 64)], EP.content_launches),
    (EP.style_loss, [(64, 64), (64, 64)], EP.style_launches),
]


@pytest.mark.parametrize("fn, cin, nweights, _count", WRAPPERS)
def test_wrappers_refuse_other_devices(fn, cin, nweights, _count):
    """Only a CPU tensor takes the plain version; any device that is neither
    CPU nor CUDA raises instead of being computed somewhere else."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(meta(1, 8, 8, cin), *[meta(1)] * nweights)


@pytest.mark.parametrize("fn, cin, nweights, count", WRAPPERS)
def test_cpu_tensors_never_count_a_launch(fn, cin, nweights, count):
    weights = [torch.full((3, 3, cin, cin), 0.01), torch.zeros(cin)] * (nweights // 2)
    before = count.n
    out = fn(torch.rand(1, 8, 8, cin), *weights)
    assert count.n == before
    assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("fn, shapes, _count", LOSS_WRAPPERS)
def test_loss_wrappers_refuse_other_devices(fn, shapes, _count):
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(*[torch.empty(shape, device="meta") for shape in shapes])


@pytest.mark.parametrize("fn, shapes, count", LOSS_WRAPPERS)
def test_loss_wrappers_on_cpu_never_count_a_launch(fn, shapes, count):
    before = count.n
    out = fn(*[0.1 * torch.rand(shape) for shape in shapes])
    assert count.n == before
    assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))
