"""Gradient rematerialization in the port: blockwise checkpoints in
``models.vgg.extract_features(remat=True)`` against ``remat=False`` and
against the JAX package's ``jax.checkpoint`` form, ``StylizeConfig.remat``
through ``stylize()``, a spy that each kernel wrapper of the chain runs its
forward twice a step under remat, the full-chain mirror that picks the auto
threshold against the real dispatch, and the auto choice itself.

On the CPU the kernel wrappers run their plain versions and count no launch
(``tests/test_torch_isolation.py``), so the spies wrap the wrappers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.models import vgg as jvgg
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch import api
from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.models.weights import from_numpy_params, random_fixture
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import dispatch

torch.set_num_threads(2)

DEFAULT_LAYERS = (("conv4_2",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1"))


@pytest.fixture(scope="module")
def st():
    params, mean, std = random_fixture(0)
    return StyleTransfer(params, mean=mean, std=std, device="cpu")


def _input(shape, seed=0, requires_grad=True):
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    return x.requires_grad_(requires_grad)


def _weighted_sum(feats):
    return sum((i + 1) * f.square().mean() for i, f in enumerate(feats[k] for k in sorted(feats)))


@pytest.mark.parametrize("layers, start_block, start_conv, pooling, shape", [
    (("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2", "conv5_1"), 1, 0, "average",
     (1, 32, 24, 3)),
    (("pool2", "conv3_3"), 1, 0, "max", (1, 18, 14, 3)),
    (("conv4_4", "pool5"), 3, 0, "average", (1, 16, 16, 128)),
    (("conv4_3", "conv5_2"), 4, 2, "average", (1, 8, 6, 512)),
])
def test_extract_features_remat_equals_stored(layers, start_block, start_conv, pooling, shape):
    """The same activations and the same input gradient, bit for bit."""
    params = vgg.init_params(1)
    outs = []
    for remat in (False, True):
        x = _input(shape)
        feats = vgg.extract_features(params, x, layers, pooling=pooling, remat=remat,
                                     start_block=start_block, start_conv=start_conv)
        (grad,) = torch.autograd.grad(_weighted_sum(feats), x)
        outs.append((feats, grad))
    (f0, g0), (f1, g1) = outs
    assert set(f0) == set(f1) == set(layers)
    for k in layers:
        assert torch.equal(f0[k], f1[k]), k
    assert torch.equal(g0, g1)


def test_extract_features_remat_matches_jax(tiny_params):
    """Against the JAX ``extract_features(remat=True)`` on the JAX fixture:
    values and input gradient at rtol 1e-4."""
    jparams = tiny_params[0]
    layers = ("conv1_1", "conv2_2", "pool3", "conv4_2", "conv5_1")
    x_np = np.random.RandomState(3).randn(1, 32, 24, 3).astype(np.float32)

    def jloss(x):
        feats = jvgg.extract_features(jparams, x, layers, remat=True, shard_divisor=None)
        return sum((i + 1) * jnp.mean(jnp.square(feats[k])) for i, k in enumerate(sorted(feats)))

    jfeats = jvgg.extract_features(jparams, jnp.asarray(x_np), layers, remat=True,
                                   shard_divisor=None)
    jgrad = jax.grad(jloss)(jnp.asarray(x_np))
    x = torch.from_numpy(x_np).requires_grad_(True)
    feats = vgg.extract_features(from_numpy_params(jparams), x, layers, remat=True)
    (grad,) = torch.autograd.grad(_weighted_sum(feats), x)
    for k in layers:
        np.testing.assert_allclose(feats[k].detach().numpy(), np.asarray(jfeats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgrad).max()))


def _losses(st, cfg, content, style):
    rows = []
    st.stylize(content, style, cfg, callback=lambda ev: rows.append(ev.losses["loss"]))
    return np.concatenate(rows)


@pytest.mark.parametrize("extra", [
    dict(),                                          # the chain
    dict(fused_block1=True),                         # block1_full + plain blocks
    dict(use_fused=False),                           # the plain path
    dict(optimizer=api.OptimizerSpec("lbfgs")),      # L-BFGS's line search
])
def test_stylize_remat_on_and_off_give_equal_losses(st, extra):
    r = np.random.RandomState(7)
    content, style = r.rand(32, 32, 3).astype(np.float32), r.rand(32, 32, 3).astype(np.float32)
    cfg = StylizeConfig(size=32, min_scale=32, iterations=(3,), chunk_size=3, **extra)
    off = _losses(st, dataclasses.replace(cfg, remat=False), content, style)
    on = _losses(st, dataclasses.replace(cfg, remat=True), content, style)
    assert len(on) == 3
    np.testing.assert_array_equal(on, off)


def _spy_wrappers(monkeypatch):
    """Count each kernel wrapper's forwards made with autograd on (the
    optimizer's steps and the checkpoints' recomputes; captures run under
    ``no_grad``)."""
    calls = {}

    def spy(name, fn):
        def wrapped(*args):
            if torch.is_grad_enabled():
                calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return wrapped

    for mod, name in ((B1, "block1_packed"), (B1, "block1_full"), (B2, "block2_fused"),
                      (CP, "pair_gram"), (CP, "pair_pool"), (CG, "conv_gram"),
                      (CS, "gram_tail")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    make = CS.make_pair_of_singles
    monkeypatch.setattr(CS, "make_pair_of_singles",
                        lambda **kw: spy(f"singles_{kw['pool']}_{kw['gram']}", make(**kw)))
    return calls


@pytest.mark.parametrize("route, expected", [
    ("chain", {"block1_packed": 1, "block2_fused": 1, "pair_gram": 2, "pair_pool": 2,
               "conv_gram": 1}),
    ("singles", {"block1_packed": 1, "singles_True_True": 1, "singles_False_True": 2,
                 "singles_True_False": 2, "gram_tail": 1}),
    ("fused_block1", {"block1_full": 1}),
])
def test_each_chain_kernel_forward_runs_twice_a_step_under_remat(st, monkeypatch, route,
                                                                 expected):
    if route == "singles":  # the large-image route: every segment as singles
        monkeypatch.setattr(dispatch, "PAIR_EFF_LIMIT", 16)
    calls = _spy_wrappers(monkeypatch)
    r = np.random.RandomState(2)
    hw = (16, 64) if route == "singles" else (32, 32)  # conv5_1 4 wide: past conv_gram
    content, style = r.rand(*hw, 3).astype(np.float32), r.rand(*hw, 3).astype(np.float32)
    cfg = StylizeConfig(size=max(hw), min_scale=max(hw), iterations=(2,), chunk_size=2,
                        fused_block1=route == "fused_block1")
    for remat, factor in ((False, 1), (True, 2)):
        calls.clear()
        st.stylize(content, style, dataclasses.replace(cfg, remat=remat))
        assert calls == {k: 2 * factor * n for k, n in expected.items()}, remat


def _plain_reached(st, monkeypatch, h, w, content_layers, style_layers):
    """Whether the real chain dispatch on an (h, w) image reaches the plain
    ``extract_features``."""
    reached = []
    real = vgg.extract_features
    monkeypatch.setattr(vgg, "extract_features",
                        lambda *a, **kw: reached.append(1) or real(*a, **kw))
    with torch.no_grad():
        st._chain_features(torch.rand(1, h, w, 3), content_layers, style_layers)
    monkeypatch.setattr(vgg, "extract_features", real)
    return bool(reached)


LAYER_SETS = [
    DEFAULT_LAYERS,
    (("conv4_2",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1")),       # configuration 3
    (("conv4_2",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_2")),
    (("conv4_2",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_3")),
    (("conv4_1",), ("conv1_1", "conv2_1", "conv3_1", "conv5_1")),
    (("conv5_1",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")),
    (("conv3_2",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")),
    (("conv4_2",), ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2")),
    (("conv2_2",), ("conv1_1", "conv2_1")),
]


@pytest.mark.parametrize("content_layers, style_layers", LAYER_SETS)
def test_full_chain_mirror_matches_real_dispatch(st, monkeypatch, content_layers, style_layers):
    """``_full_chain_dispatches`` (the auto-remat mirror of the chain's gates)
    says True exactly where ``_chain_features`` never reaches the plain
    ``extract_features``: at every shape whose pool boundaries are even or
    odd, for layer sets on and off the chain."""
    for h, w in ((32, 32), (16, 48), (48, 16), (24, 32), (32, 40), (40, 40), (34, 32),
                 (32, 36), (8, 16)):
        mirror = st._full_chain_dispatches(h, w, content_layers, style_layers)
        assert mirror == (not _plain_reached(st, monkeypatch, h, w, content_layers,
                                             style_layers)), (h, w)


def test_full_chain_mirror_other_models_and_real_sizes():
    params, mean, std = random_fixture(0)
    st_max = StyleTransfer(params, mean=mean, std=std, pooling="max", device="cpu")
    assert not st_max._full_chain_dispatches(32, 32, *DEFAULT_LAYERS)
    st16 = StyleTransfer(random_fixture(0, arch="vgg16")[0], device="cpu")
    assert not st16._full_chain_dispatches(32, 32, *DEFAULT_LAYERS)
    st19 = StyleTransfer(params, mean=mean, std=std, device="cpu")
    # the sizes of the shipped configurations: 16 divides both sides or not
    assert st19._full_chain_dispatches(4096, 4096, *DEFAULT_LAYERS)
    assert st19._full_chain_dispatches(2160, 3840, *DEFAULT_LAYERS)
    assert not st19._full_chain_dispatches(1080, 1920, *DEFAULT_LAYERS)


def test_auto_remat_follows_the_threshold_of_the_route(st, monkeypatch):
    """``remat=None`` turns remat on from the route's threshold: the full
    chain's at a shape it carries whole, the plain path's elsewhere; an
    explicit True or False wins."""
    monkeypatch.setattr(api, "REMAT_AUTO_PIXELS", 24 * 24)
    monkeypatch.setattr(api, "REMAT_AUTO_PIXELS_FUSED", 48 * 48)
    chain, plain = StylizeConfig(), StylizeConfig(use_fused=False)
    assert not st._use_remat(chain, 32, 32) and st._use_remat(chain, 48, 48)
    assert st._use_remat(chain, 34, 34)          # odd pool boundaries: plain's threshold
    assert st._use_remat(plain, 32, 32) and not st._use_remat(plain, 16, 32)
    assert not st._use_remat(dataclasses.replace(chain, remat=False), 64, 64)
    assert st._use_remat(dataclasses.replace(chain, remat=True), 16, 16)

    calls = _spy_wrappers(monkeypatch)
    r = np.random.RandomState(4)
    style = r.rand(32, 32, 3).astype(np.float32)
    for size, factor in ((32, 1), (48, 2)):  # below and at the patched full-chain threshold
        calls.clear()
        st.stylize(r.rand(size, size, 3).astype(np.float32), style,
                   StylizeConfig(size=size, min_scale=size, iterations=(1,), chunk_size=1))
        assert calls["block1_packed"] == factor and calls["conv_gram"] == factor, size
