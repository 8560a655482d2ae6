"""Offline VGG weight converter (VGG-19/VGG-16) -> the runtime's .npz format.

Twin of the JAX package's ``scripts/convert_weights.py`` with the same
command line, the same torchvision feature indices, the same caffe BGR mean
and the same shape errors; it imports ``torch`` and numpy and never JAX, so
a PyTorch-only install can make the ``.npz`` that
``python -m style_transfer_tpu_torch --weights`` reads. Both converters
write one schema (``models/weights.py``): on the same input their outputs
hold the same keys, dtypes, shapes and values (not the same bytes: ``np.savez``
stamps each zip entry with the time).

Supported inputs:

- torch checkpoint (``.pth``/``.pt``): a torchvision-layout VGG state_dict
  (``features.<idx>.weight`` OIHW), loaded with ``weights_only=True``.
  Writes torch-style normalization metadata (RGB, [0,1], ImageNet mean/std).
    python -m style_transfer_tpu_torch.scripts.convert_weights torch vgg19.pth vgg19.npz
- raw npz with caffe-style names (``conv1_1_w`` (cout, cin, kh, kw) +
  ``conv1_1_b``), as exported by any caffe-dumping tool. Writes caffe-style
  metadata (input scaled to [0,255] around BGR means -> the loader's
  ``meta.bgr`` flips conv1_1 so the runtime stays RGB).
    python -m style_transfer_tpu_torch.scripts.convert_weights caffe-npz dump.npz vgg19.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.models.weights import save_npz

# torchvision vgg<N>.features module indices of the conv layers, in order.
_TORCH_FEATURE_IDX = {
    "vgg19": [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34],
    "vgg16": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28],
}

# Caffe VGG input space: BGR, 0-255, mean-subtracted (no std scaling). In the
# runtime's RGB-[0,1] pipeline that becomes mean/255 with std 1/255.
_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def _layer(name: str, w: np.ndarray, b: np.ndarray, arch: str, layout: str):
    """One conv's ``{"kernel", "bias"}`` from its (cout, cin, 3, 3) weight,
    HWIO as the runtime reads it."""
    cin, cout = vgg.conv_in_channels(name, arch), vgg.layer_channels(arch)[name]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"{name}: unexpected {layout} shape {w.shape}")
    kernel = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # -> HWIO
    return {"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(b)}


def convert_torch(src: str, dst: str, arch: str = "vgg19") -> None:
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params = {
        name: _layer(name, sd[f"features.{idx}.weight"].numpy(),
                     sd[f"features.{idx}.bias"].numpy(), arch, "torch")
        for name, idx in zip(vgg.conv_names(arch), _TORCH_FEATURE_IDX[arch])
    }
    save_npz(dst, params, arch=arch)  # default ImageNet RGB mean/std metadata
    print(f"wrote {dst} ({arch}, torch layout, RGB/ImageNet normalization)")


def convert_caffe_npz(src: str, dst: str, arch: str = "vgg19") -> None:
    with np.load(src) as z:
        params = {
            name: _layer(name, np.asarray(z[f"{name}_w"], np.float32),
                         np.asarray(z[f"{name}_b"], np.float32), arch, "caffe")
            for name in vgg.conv_names(arch)
        }
    # runtime input x is RGB in [0,1]; caffe net saw 255*BGR - mean_bgr.
    # (x - mean/255) / (1/255) reproduces that numerically; meta.bgr makes the
    # loader flip conv1_1's input channels so x itself can stay RGB.
    mean_rgb = tuple(m / 255.0 for m in reversed(_CAFFE_MEAN_BGR))
    std = (1.0 / 255.0,) * 3
    save_npz(dst, params, mean=mean_rgb, std=std, bgr=True, arch=arch)
    print(f"wrote {dst} ({arch}, caffe layout, BGR-flipped conv1_1, 0-255 normalization)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("format", choices=["torch", "caffe-npz"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--arch", choices=["vgg19", "vgg16"], default="vgg19")
    args = p.parse_args(argv)
    if args.format == "torch":
        convert_torch(args.src, args.dst, args.arch)
    else:
        convert_caffe_npz(args.src, args.dst, args.arch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
