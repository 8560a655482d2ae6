"""Image I/O and on-device preprocessing (PyTorch port).

Counterpart of ``style_transfer_tpu/utils/imgio.py``: PIL only at the edges
(decode/encode), a float32 RGB-in-[0,1] NHWC pipeline in between, and the
between-scale resize on the device.

``resize_image`` reproduces ``jax.image.resize(..., "lanczos3")`` followed by
a clip to [0, 1]: torch has no Lanczos resize, so the separable
scale-and-translate weight matrices of ``jax/_src/image/scale.py`` (Lanczos-3
kernel, widened by the scale factor on downsample — JAX's antialiasing — and
renormalized per output sample) are built here and applied one axis at a
time. Axes whose size does not change are left alone, as JAX does.
"""

from __future__ import annotations

import io
import math
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Decode an image file to RGB (H, W, 3): float in [0, 1], or uint8 with
    ``dtype=np.uint8`` (:func:`to_nhwc` converts it on the device)."""
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    if dtype == np.uint8:
        return arr
    return np.asarray(arr, dtype) / dtype(255.0)


def to_uint8(arr) -> np.ndarray:
    """Clip a float image in [0, 1] to uint8; (H, W, 3) or (1, H, W, 3),
    tensors or arrays; uint8 input passes through."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(f"expected batch of 1, got shape {arr.shape}")
        arr = arr[0]
    if arr.dtype == np.uint8:
        return arr
    arr = np.asarray(arr, np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_image(arr, path: str) -> None:
    """Encode a float RGB image in [0, 1] to a file."""
    Image.fromarray(to_uint8(arr)).save(path)


def encode_image(arr, format: str = "JPEG", quality: int = 85) -> bytes:
    """Encode to in-memory JPEG or PNG bytes (the web monitor's frames)."""
    buf = io.BytesIO()
    im = Image.fromarray(to_uint8(arr))
    if format.upper() == "JPEG":
        im.save(buf, format="JPEG", quality=quality)
    else:
        im.save(buf, format=format.upper())
    return buf.getvalue()


def quantize_u8(image: torch.Tensor) -> torch.Tensor:
    """Device-side :func:`to_uint8`: (1, H, W, 3) float -> (H, W, 3) uint8,
    bit-matching the host path (clip, *255, +0.5, truncate)."""
    x = image[0].to(torch.float32).clamp(0.0, 1.0) * 255.0 + 0.5
    return x.to(torch.uint8)


def to_nhwc(arr, device: Optional[torch.device] = None) -> torch.Tensor:
    """(H, W, 3) -> (1, H, W, 3) float32 tensor on ``device``; uint8 input
    is moved as-is and scaled to [0, 1] there."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    t = t.to(device) if device is not None else t
    if t.ndim == 3:
        t = t[None]
    if t.ndim != 4 or t.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) or (N, H, W, 3), got {tuple(t.shape)}")
    if t.dtype == torch.uint8:
        # times the fp32 reciprocal, as XLA compiles the JAX package's / 255
        return t.to(torch.float32) * (1.0 / 255.0)
    return t.to(torch.float32)


def _constant(v, like: torch.Tensor, name: str) -> torch.Tensor:
    """A per-channel constant to broadcast against ``like``. A tensor is used
    as it is and must already lie on ``like``'s device in its dtype (no copy:
    ``StyleTransfer`` makes its own once, so an objective evaluation on the
    card makes no host-to-device copy, which would wait for the device);
    anything else is copied there."""
    if not isinstance(v, torch.Tensor):
        return torch.as_tensor(np.asarray(v, np.float32), dtype=like.dtype, device=like.device)
    if v.device != like.device or v.dtype != like.dtype:
        raise ValueError(f"{name} must be a {like.dtype} tensor on {like.device}, "
                         f"got {v.dtype} on {v.device}")
    return v


def preprocess(image: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """RGB [0,1] NHWC -> network input space."""
    return (image - _constant(mean, image, "mean")) / _constant(std, image, "std")


def deprocess(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Inverse of :func:`preprocess`."""
    return x * _constant(std, x, "std") + _constant(mean, x, "mean")


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(
        x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x * x, torch.ones_like(x)),
        torch.ones_like(x),
    )
    return torch.where(x > radius, torch.zeros_like(x), out)


def _weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in, out) resampling weights of ``jax.image.scale_and_translate``
    (``compute_weight_mat``) for a pure scale, Lanczos-3, antialiased."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _lanczos3((sample_f[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(
        total.abs() > eps,
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_image(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Lanczos-3 resize of an NHWC float image to (H, W) = ``size``, clipped
    to [0, 1] (lanczos overshoots near edges; images live in [0, 1])."""
    _, h_in, w_in, _ = image.shape
    h, w = size
    out = image.to(torch.float32)
    if h != h_in:
        out = torch.einsum("nhwc,hk->nkwc", out, _weight_mat(h_in, h, image.device))
    if w != w_in:
        out = torch.einsum("nhwc,wk->nhkc", out, _weight_mat(w_in, w, image.device))
    return out.clamp(0.0, 1.0)


def scale_size(size: Tuple[int, int], long_side: int) -> Tuple[int, int]:
    """Proportionally scale (H, W) so the longer side equals ``long_side``."""
    h, w = size
    if h >= w:
        return long_side, max(1, round(w * long_side / h))
    return max(1, round(h * long_side / w)), long_side
