"""VGG weight loading and fixtures (PyTorch port).

Counterpart of ``style_transfer_tpu/models/weights.py`` on the same ``.npz``
schema: ``<layer>.kernel`` (3, 3, cin, cout) float32 HWIO, ``<layer>.bias``
(cout,), ``meta.mean`` / ``meta.std`` (3,), ``meta.bgr`` (swap conv1_1's
input channels on load) and ``meta.arch``. A file written by either package
loads in the other.

``random_fixture`` draws from ``numpy.random.RandomState`` (He-normal at the
full VGG widths), so its values differ from the JAX package's
``jax.random`` fixture of the same seed; hand the JAX fixture to the port
with :func:`from_numpy_params` where the two must see the same weights.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.utils.imgio import IMAGENET_MEAN, IMAGENET_STD

Params = vgg.Params


def save_npz(path: str, params: Params, mean=IMAGENET_MEAN, std=IMAGENET_STD,
             bgr: bool = False, arch: str = None) -> None:
    flat = {}
    for name, p in params.items():
        flat[f"{name}.kernel"] = np.asarray(p["kernel"].detach().cpu(), np.float32)
        flat[f"{name}.bias"] = np.asarray(p["bias"].detach().cpu(), np.float32)
    flat["meta.mean"] = np.asarray(mean, np.float32)
    flat["meta.std"] = np.asarray(std, np.float32)
    flat["meta.bgr"] = np.asarray(1 if bgr else 0, np.int32)
    flat["meta.arch"] = np.asarray(arch or vgg.infer_arch(params))
    np.savez(path, **flat)


def load_npz(path: str) -> Tuple[Params, np.ndarray, np.ndarray]:
    """Load (params, mean, std) as float32 CPU tensors, validating shapes
    against the declared arch (``meta.arch``, VGG-19 for older files)."""
    with np.load(path) as z:
        mean = z.get("meta.mean", np.asarray(IMAGENET_MEAN, np.float32))
        std = z.get("meta.std", np.asarray(IMAGENET_STD, np.float32))
        bgr = int(z.get("meta.bgr", 0))
        arch = str(z.get("meta.arch", vgg.DEFAULT_ARCH))
        channels = vgg.layer_channels(arch)
        params: Params = {}
        for name in vgg.conv_names(arch):
            kernel = np.asarray(z[f"{name}.kernel"], np.float32)
            bias = np.asarray(z[f"{name}.bias"], np.float32)
            cin, cout = vgg.conv_in_channels(name, arch), channels[name]
            if kernel.shape != (3, 3, cin, cout):
                raise ValueError(
                    f"{name}.kernel: expected (3, 3, {cin}, {cout}), got {kernel.shape}"
                )
            if bias.shape != (cout,):
                raise ValueError(f"{name}.bias: expected ({cout},), got {bias.shape}")
            if bgr and name == "conv1_1":
                kernel = kernel[:, :, ::-1, :]  # caffe weights read BGR input
            params[name] = {
                "kernel": torch.from_numpy(np.ascontiguousarray(kernel)),
                "bias": torch.from_numpy(bias),
            }
    return params, mean, std


def random_fixture(seed: int = 0, arch: str = vgg.DEFAULT_ARCH) -> Tuple[Params, np.ndarray, np.ndarray]:
    """Deterministic numpy-drawn VGG weights + default normalization."""
    return (
        vgg.init_params(seed, arch),
        np.asarray(IMAGENET_MEAN, np.float32),
        np.asarray(IMAGENET_STD, np.float32),
    )


def from_numpy_params(params: Mapping[str, Mapping[str, object]]) -> Params:
    """Any ``{layer: {"kernel", "bias"}}`` of array-likes (e.g. the JAX
    package's params, leaf by leaf through ``np.asarray``) -> float32 CPU
    tensors in the same HWIO layout."""
    return {
        name: {
            k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for k, v in p.items()
        }
        for name, p in params.items()
    }
