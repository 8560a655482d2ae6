"""The port's weight converter against the JAX package's, on the same inputs.

``python -m style_transfer_tpu_torch.scripts.convert_weights`` must write
what ``scripts/convert_weights.py`` writes, array for array (keys, dtypes,
shapes, values; not bytes: ``np.savez`` stamps its zip entries with the
time), for a torchvision ``state_dict`` (VGG-19 and VGG-16) and a
caffe-named ``.npz``, raise the same shape errors, and run with no JAX
module loaded. The inputs are built here from a seed: nothing is
downloaded.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer_tpu_torch.models import vgg, weights
from style_transfer_tpu_torch.scripts import convert_weights as CW

REPO = Path(__file__).resolve().parents[1]


def _jax_converter():
    """``scripts/convert_weights.py`` (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location("jax_convert_weights",
                                                  REPO / "scripts" / "convert_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _state_dict(arch, seed=0):
    r = np.random.RandomState(seed)
    sd = {}
    for name, idx in zip(vgg.conv_names(arch), CW._TORCH_FEATURE_IDX[arch]):
        cin, cout = vgg.conv_in_channels(name, arch), vgg.layer_channels(arch)[name]
        sd[f"features.{idx}.weight"] = torch.tensor(r.randn(cout, cin, 3, 3).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.tensor(r.randn(cout).astype(np.float32))
    return sd


def _caffe(arch="vgg19", seed=2):
    r = np.random.RandomState(seed)
    flat = {}
    for name in vgg.conv_names(arch):
        cin, cout = vgg.conv_in_channels(name, arch), vgg.layer_channels(arch)[name]
        flat[f"{name}_w"] = r.randn(cout, cin, 3, 3).astype(np.float32)
        flat[f"{name}_b"] = r.randn(cout).astype(np.float32)
    return flat


def _same_arrays(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert list(za.keys()) == list(zb.keys())
        for k in za.keys():
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_module_constants_equal_the_jax_converters():
    jc = _jax_converter()
    assert CW._TORCH_FEATURE_IDX == jc._TORCH_FEATURE_IDX
    assert CW._CAFFE_MEAN_BGR == jc._CAFFE_MEAN_BGR


@pytest.mark.parametrize("arch", ["vgg19", "vgg16"])
def test_torch_route_equals_the_jax_converter(arch, tmp_path):
    src = tmp_path / "vgg.pth"
    torch.save(_state_dict(arch), src)
    CW.main(["torch", str(src), str(tmp_path / "port.npz"), "--arch", arch])
    _jax_converter().convert_torch(str(src), str(tmp_path / "jax.npz"), arch)
    _same_arrays(tmp_path / "port.npz", tmp_path / "jax.npz")
    params, mean, std = weights.load_npz(str(tmp_path / "port.npz"))
    assert vgg.infer_arch(params) == arch
    np.testing.assert_allclose(mean, [0.485, 0.456, 0.406], rtol=1e-6)


def test_caffe_route_equals_the_jax_converter(tmp_path):
    flat = _caffe()
    np.savez(tmp_path / "caffe.npz", **flat)
    CW.main(["caffe-npz", str(tmp_path / "caffe.npz"), str(tmp_path / "port.npz")])
    _jax_converter().convert_caffe_npz(str(tmp_path / "caffe.npz"), str(tmp_path / "jax.npz"))
    _same_arrays(tmp_path / "port.npz", tmp_path / "jax.npz")
    params, mean, std = weights.load_npz(str(tmp_path / "port.npz"))
    # the loader flips conv1_1's input channels (meta.bgr)
    np.testing.assert_array_equal(params["conv1_1"]["kernel"].numpy()[:, :, 0, :],
                                  flat["conv1_1_w"].transpose(2, 3, 1, 0)[:, :, 2, :])
    np.testing.assert_allclose(std, [1 / 255.0] * 3, rtol=1e-6)


@pytest.mark.parametrize("route", ["torch", "caffe-npz"])
def test_bad_shapes_raise_the_jax_converters_errors(route, tmp_path):
    if route == "torch":
        sd = _state_dict("vgg19")
        sd["features.0.weight"] = torch.zeros(64, 4, 3, 3)
        torch.save(sd, tmp_path / "bad.pth")
        src, call = tmp_path / "bad.pth", "convert_torch"
    else:
        flat = {f"{n}_w": np.zeros((1, 1, 3, 3), np.float32) for n in vgg.CONV_NAMES}
        flat.update({f"{n}_b": np.zeros(1, np.float32) for n in vgg.CONV_NAMES})
        np.savez(tmp_path / "bad.npz", **flat)
        src, call = tmp_path / "bad.npz", "convert_caffe_npz"
    with pytest.raises(ValueError) as want:
        getattr(_jax_converter(), call)(str(src), str(tmp_path / "jax.npz"))
    with pytest.raises(ValueError) as got:
        getattr(CW, call)(str(src), str(tmp_path / "port.npz"))
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "port.npz").exists()


def test_python_m_runs_without_jax(tmp_path):
    torch.save(_state_dict("vgg16", seed=1), tmp_path / "vgg16.pth")
    code = ("import runpy, sys\n"
            "sys.argv = ['convert_weights', 'torch', sys.argv[1], sys.argv[2], '--arch', 'vgg16']\n"
            "runpy.run_module('style_transfer_tpu_torch.scripts.convert_weights',"
            " run_name='__main__', alter_sys=True)\n")
    check = ("import sys\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
             " 'style_transfer_tpu'))\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", f"try:\n    exec({code!r})\nexcept SystemExit as e:\n"
                               f"    assert not e.code, e.code\nexec({check!r})\n",
         str(tmp_path / "vgg16.pth"), str(tmp_path / "out.npz")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote" in proc.stdout
    params, _, _ = weights.load_npz(str(tmp_path / "out.npz"))
    assert vgg.infer_arch(params) == "vgg16"
