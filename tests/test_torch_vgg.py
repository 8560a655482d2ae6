"""The port's VGG feature extractor and weight I/O against the JAX package.

Same weights (the JAX ``random_fixture``, passed over with
``from_numpy_params``), same numpy inputs, fp32 on the CPU: activations at
rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.models import vgg as jvgg
from style_transfer_tpu.models import weights as jweights
from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.models import weights

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def both_params(tiny_params):
    jparams, _, _ = tiny_params
    return jparams, weights.from_numpy_params(jparams)


def _x(shape=(1, 20, 18, 3), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "layers",
    [
        ("conv1_1",),
        ("pool1", "conv2_2"),
        ("conv3_1", "pool3"),
        ("conv4_2", "conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1"),
        ("conv5_4", "pool5"),
    ],
)
def test_extract_features_matches_jax(both_params, layers):
    """(1, 20, 18, 3): odd pool edges from pool2 on (10x9 -> 5x5 -> 3x3)."""
    jparams, tparams = both_params
    x = _x()
    ref = jvgg.extract_features(jparams, jnp.asarray(x), layers, shard_divisor=None)
    out = vgg.extract_features(tparams, torch.from_numpy(x), layers)
    assert set(out) == set(ref) == set(layers)
    for name in layers:
        assert tuple(out[name].shape) == ref[name].shape
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=RTOL, atol=ATOL)


def test_extract_features_vgg16_matches_jax():
    jparams, _, _ = jweights.random_fixture(0, arch="vgg16")
    tparams = weights.from_numpy_params(jparams)
    assert vgg.infer_arch(tparams) == "vgg16"
    x = _x(seed=1)
    layers = ("conv3_3", "conv5_1")
    ref = jvgg.extract_features(jparams, jnp.asarray(x), layers, arch="vgg16", shard_divisor=None)
    out = vgg.extract_features(tparams, torch.from_numpy(x), layers, arch="vgg16")
    for name in layers:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "seam, start_block, start_conv, layers",
    [
        ("pool1", 2, 0, ("conv2_1", "pool2")),
        ("pool2", 3, 0, ("conv3_1", "conv4_2")),
        ("conv4_2", 4, 2, ("conv4_4", "conv5_1")),
    ],
)
def test_start_block_handover_matches_jax(both_params, seam, start_block, start_conv, layers):
    """Resuming from a seam activation gives the full forward's activations,
    in both packages."""
    jparams, tparams = both_params
    x = _x((1, 32, 24, 3), seed=2)
    full = vgg.extract_features(tparams, torch.from_numpy(x), (seam,) + layers)
    resumed = vgg.extract_features(
        tparams, full[seam], layers, start_block=start_block, start_conv=start_conv
    )
    ref = jvgg.extract_features(
        jparams, jnp.asarray(full[seam].numpy()), layers, shard_divisor=None,
        start_block=start_block, start_conv=start_conv,
    )
    for name in layers:
        np.testing.assert_allclose(resumed[name].numpy(), full[name].numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(resumed[name].numpy(), np.asarray(ref[name]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("odd", [(1, 5, 6, 2), (1, 6, 5, 2), (1, 5, 5, 2)])
@pytest.mark.parametrize("mode", ["average", "max"])
def test_pool_odd_edges_match_jax(odd, mode):
    x = _x(odd, seed=3)
    np.testing.assert_allclose(
        vgg.pool2x2(torch.from_numpy(x), mode).numpy(),
        np.asarray(jvgg._pool(jnp.asarray(x), mode, None)), rtol=RTOL, atol=ATOL,
    )


def test_npz_round_trip_through_both_packages(tmp_path, both_params):
    jparams, tparams = both_params
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jweights.save_npz(jpath, jparams)
    weights.save_npz(tpath, tparams)
    for path in (jpath, tpath):
        jp, jmean, jstd = jweights.load_npz(path)
        tp, tmean, tstd = weights.load_npz(path)
        np.testing.assert_array_equal(tmean, jmean)
        np.testing.assert_array_equal(tstd, jstd)
        assert set(tp) == set(jp) == set(vgg.conv_names())
        for name in jp:
            for k in ("kernel", "bias"):
                assert tp[name][k].dtype == torch.float32
                np.testing.assert_array_equal(tp[name][k].numpy(), np.asarray(jp[name][k]))


def test_npz_bgr_swap_matches_jax(tmp_path, both_params):
    jparams, _ = both_params
    path = str(tmp_path / "bgr.npz")
    jweights.save_npz(path, jparams, bgr=True)
    jp, _, _ = jweights.load_npz(path)
    tp, _, _ = weights.load_npz(path)
    np.testing.assert_array_equal(tp["conv1_1"]["kernel"].numpy(), np.asarray(jp["conv1_1"]["kernel"]))


def test_npz_shape_mismatch_raises(tmp_path, both_params):
    _, tparams = both_params
    bad = dict(tparams)
    bad["conv2_1"] = {"kernel": torch.zeros(3, 3, 64, 64), "bias": torch.zeros(64)}
    path = str(tmp_path / "bad.npz")
    weights.save_npz(path, bad, arch="vgg19")
    with pytest.raises(ValueError, match="conv2_1.kernel"):
        weights.load_npz(path)


def test_fixture_is_numpy_drawn_he_normal():
    """Full VGG-19 widths, He-normal scale, deterministic per seed, and not
    the JAX fixture's values (a different generator)."""
    a, mean, std = weights.random_fixture(0)
    b, _, _ = weights.random_fixture(0)
    c, _, _ = weights.random_fixture(1)
    assert vgg.infer_arch(a) == "vgg19"
    for name in vgg.conv_names():
        k = a[name]["kernel"]
        assert tuple(k.shape) == (3, 3, vgg.conv_in_channels(name), vgg.layer_channels()[name])
        torch.testing.assert_close(k, b[name]["kernel"])
    assert not torch.equal(a["conv3_1"]["kernel"], c["conv3_1"]["kernel"])
    k = a["conv4_1"]["kernel"]
    assert abs(float(k.std()) - np.sqrt(2.0 / (9 * 256))) < 2e-3
    jp, _, _ = jweights.random_fixture(0)
    assert not np.allclose(a["conv1_1"]["kernel"].numpy(), np.asarray(jp["conv1_1"]["kernel"]))
    np.testing.assert_array_equal(mean, np.float32([0.485, 0.456, 0.406]))
    np.testing.assert_array_equal(std, np.float32([0.229, 0.224, 0.225]))


def test_layer_tables_and_errors_match_jax():
    for arch in ("vgg19", "vgg16"):
        assert vgg.conv_names(arch) == jvgg.conv_names(arch)
        assert vgg.layer_names(arch) == jvgg.layer_names(arch)
        assert vgg.layer_channels(arch) == jvgg.layer_channels(arch)
        assert vgg.blocks(arch) == jvgg.blocks(arch)
    assert vgg.deepest_layer(["conv1_1", "pool3", "conv2_2"]) == "pool3"
    with pytest.raises(ValueError, match="unknown vgg19 layer"):
        vgg.deepest_layer(["conv9_9"])
    with pytest.raises(ValueError, match="unknown arch"):
        vgg.blocks("resnet")
    with pytest.raises(ValueError, match="no supported arch"):
        vgg.infer_arch({"conv1_1": {}})
    with pytest.raises(ValueError, match="no layers"):
        vgg.extract_features({}, torch.zeros(1, 8, 8, 3), ())
