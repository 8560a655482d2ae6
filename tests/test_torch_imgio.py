"""The port's image I/O against the JAX package: the hand-built Lanczos-3
resize against ``jax.image.resize`` (atol 1e-5), and bit-equal
preprocessing and uint8 quantization."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.utils import imgio as jimgio
from style_transfer_tpu_torch.utils import imgio

torch.set_num_threads(2)


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "src, size",
    [
        ((1, 32, 32, 3), (64, 64)),   # upsample
        ((1, 64, 64, 3), (24, 24)),   # downsample by a non-integer factor (antialiased)
        ((1, 64, 48, 3), (24, 20)),   # both axes, non-integer factors
        ((1, 40, 48, 3), (40, 96)),   # one axis unchanged
        ((1, 24, 32, 3), (48, 64)),   # the ladder's 2x step
        ((1, 3, 5, 3), (17, 2)),      # tiny and extreme
    ],
)
def test_resize_matches_jax_lanczos3(src, size):
    x = _img(src)
    ref = np.asarray(jimgio.resize_image(jnp.asarray(x), size))
    out = imgio.resize_image(torch.from_numpy(x), size).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_preprocess_and_deprocess_bit_equal():
    x = _img((1, 9, 7, 3), seed=1)
    mean, std = np.float32([0.4, 0.5, 0.6]), np.float32([0.2, 0.25, 0.3])
    for m, s in (((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)), (mean, std)):
        p = imgio.preprocess(torch.from_numpy(x), m, s).numpy()
        np.testing.assert_array_equal(p, np.asarray(jimgio.preprocess(jnp.asarray(x), m, s)))
        np.testing.assert_array_equal(
            imgio.deprocess(torch.from_numpy(p), m, s).numpy(),
            np.asarray(jimgio.deprocess(jnp.asarray(p), m, s)),
        )


def test_quantize_u8_bit_equal():
    x = np.concatenate(
        [_img((1, 8, 8, 3), seed=2).ravel() * 1.4 - 0.2,
         np.float32([0.0, 1.0, 0.5 / 255, 1.5 / 255, -0.0, 254.5 / 255, 1e-9])]
    )
    x = np.resize(x, (1, 10, 20, 3)).astype(np.float32)
    out = imgio.quantize_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jimgio.quantize_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(out, jimgio.to_uint8(x))
    np.testing.assert_array_equal(imgio.to_uint8(x), jimgio.to_uint8(x))
    np.testing.assert_array_equal(imgio.to_uint8(out), out)  # uint8 passes through


def test_to_nhwc_matches_jax():
    u8 = (np.random.RandomState(3).rand(6, 5, 3) * 255).astype(np.uint8)
    f = _img((6, 5, 3), seed=4)
    for arr in (u8, f):
        out = imgio.to_nhwc(arr)
        assert out.dtype == torch.float32 and tuple(out.shape) == (1, 6, 5, 3)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jimgio.to_nhwc(arr)))
    with pytest.raises(ValueError, match="expected"):
        imgio.to_nhwc(np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("hw, long_side", [((480, 640), 512), ((640, 480), 256), ((7, 3), 64), ((3, 1000), 8)])
def test_scale_size_matches_jax(hw, long_side):
    assert imgio.scale_size(hw, long_side) == jimgio.scale_size(hw, long_side)


def test_load_save_round_trip(tmp_path):
    x = _img((12, 10, 3), seed=5)
    path = str(tmp_path / "img.png")
    imgio.save_image(x, path)
    np.testing.assert_array_equal(imgio.load_image(path, np.uint8), jimgio.to_uint8(x))
    np.testing.assert_array_equal(imgio.load_image(path), jimgio.load_image(path))
