"""The slice as a whole: the port's fused objective and ``stylize()`` against
the JAX package, and a spy that the kernel chain carried the objective.

Both packages use the JAX fixture weights and the same numpy images, fp32 on
the CPU, where the port's chain runs each kernel's plain version. JAX runs
its plain-XLA objective (``use_fused=False``, the oracle the Pallas kernels
are checked against). Post-Adam pixels are not compared (ROADMAP.md:
near-zero gradients flip sign under Adam); losses and gradients are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.optim import OptimizerSpec as JOptimizerSpec
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch.models import vgg as vgg_mod
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.optim import OptimizerSpec

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def packages(tiny_params):
    jparams, mean, std = tiny_params
    jst = JStyleTransfer(jparams, mean=mean, std=std)
    pst = StyleTransfer(from_numpy_params(jparams), mean=mean, std=std, device="cpu")
    return jst, pst


@pytest.fixture(scope="module")
def images():
    r = np.random.RandomState(42)
    content = r.rand(64, 48, 3).astype(np.float32)
    style = r.rand(48, 64, 3).astype(np.float32)
    return content, style


def test_fused_objective_matches_jax_oracle(packages, images):
    """Loss terms and image gradient at (64, 48), default layers and weights,
    content init plus a small perturbation (so the content term is live)."""
    jst, pst = packages
    content, style = images
    cfg = StylizeConfig(size=(64, 48))
    jcfg = JStylizeConfig(size=(64, 48), use_fused=False)
    image = np.clip(
        content + 0.05 * np.random.RandomState(5).randn(*content.shape), 0, 1
    ).astype(np.float32)[None]

    # JAX oracle: plain-XLA capture and objective
    jc = jnp.asarray(content)[None]
    js = jnp.asarray(style)[None]
    c_weights = JL.normalize_layer_weights(jcfg.content_layers)
    s_weights = JL.normalize_layer_weights(jcfg.style_layers)
    all_layers = tuple(dict.fromkeys(list(jcfg.content_layers) + list(jcfg.style_layers)))
    c_t = jst._features(jst.params, jc, jcfg.content_layers)
    s_t = {k: JL.gram_matrix(v) for k, v in jst._features(jst.params, js, jcfg.style_layers).items()}
    objective = jst._build_objective(
        jcfg, c_weights=c_weights, s_weights=s_weights, all_layers=all_layers,
        gram_fn=JL.gram_matrix, loss_fns={}, fused_b1=False, packed_b1=False,
        packed_b2=False, packed_b3=False, packed_b4=False,
    )
    (jloss, jterms), jgrad = jax.value_and_grad(
        lambda im: objective(jst.params, im, c_t, s_t), has_aux=True
    )(jnp.asarray(image))

    # port: the chain (plain versions on the CPU) for capture and objective
    tc = torch.from_numpy(content)[None]
    ts = torch.from_numpy(style)[None]
    pc_t = pst._capture_content(cfg, tc)
    ps_t = pst._capture_style(cfg, ts)
    x = torch.from_numpy(image).requires_grad_(True)
    loss, terms = pst._build_objective(cfg)(x, pc_t, ps_t)
    (grad,) = torch.autograd.grad(loss, x)

    for k in ("loss", "content", "style", "tv"):
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-3, atol=1e-6)


def test_stylize_loss_curve_matches_jax(packages, images):
    """Two-scale ladder (32 -> 64), three Adam steps each, content init:
    per-step loss terms at rtol 1e-4."""
    jst, pst = packages
    content, style = images
    kw = dict(size=64, min_scale=32, iterations=(3,), chunk_size=3,
              optimizer=OptimizerSpec("adam", learning_rate=0.05))
    jkw = dict(kw, optimizer=JOptimizerSpec("adam", learning_rate=0.05))
    jev, pev = [], []
    jout = jst.stylize(content, style, JStylizeConfig(warm_compile=False, **jkw), callback=jev.append)
    pout = pst.stylize(content, style, StylizeConfig(**kw), callback=pev.append)
    assert [e.size for e in pev] == [e.size for e in jev] == [(32, 24), (64, 48)]
    for pe, je in zip(pev, jev):
        for k in ("loss", "content", "style", "tv"):
            np.testing.assert_allclose(pe.losses[k], je.losses[k], rtol=1e-4, atol=1e-9)
    assert pout.shape == jout.shape == (64, 48, 3)
    assert np.isfinite(pout).all() and pout.min() >= 0.0 and pout.max() <= 1.0
    assert pev[-1].done and not pev[0].done


def test_chain_carries_the_fused_objective(packages, images, monkeypatch):
    """block1 -> block2 -> pairs -> conv_gram -> tv carry every step and the
    captures; the plain extract_features is never entered mid-chain."""
    _, pst = packages
    content, style = images
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in [(B1, "block1_packed"), (B2, "block2_fused"), (CP, "pair_gram"),
                         (CP, "pair_pool"), (CG, "conv_gram"), (EP, "tv_loss")]:
        spy(module, name)
    real_extract = vgg_mod.extract_features

    def spy_extract(*a, **kw):
        assert kw.get("start_block", 1) == 1, "objective fell back to extract_features mid-chain"
        calls["extract_features"] = calls.get("extract_features", 0) + 1
        return real_extract(*a, **kw)

    monkeypatch.setattr(vgg_mod, "extract_features", spy_extract)
    steps = 2
    pst.stylize(content, style, StylizeConfig(size=(64, 48), min_scale=64, iterations=(steps,)))
    # one objective per step, plus the content and the style capture
    assert calls["block1_packed"] == calls["block2_fused"] == calls["conv_gram"] + 1 == steps + 2
    assert calls["pair_gram"] == 2 * steps + 4  # conv3 and conv4 fronts, every pass
    assert calls["pair_pool"] == 2 * steps + 3  # the content capture stops at conv4_2: no conv4 tail
    assert calls["tv_loss"] == steps
    assert "extract_features" not in calls


def test_unfused_and_fused_agree_on_cpu(packages, images):
    _, pst = packages
    content, style = images
    kw = dict(size=(32, 24), min_scale=32, iterations=(2,))
    a, b = [], []
    pst.stylize(content, style, StylizeConfig(**kw), callback=a.append)
    pst.stylize(content, style, StylizeConfig(use_fused=False, **kw), callback=b.append)
    np.testing.assert_allclose(a[0].losses["loss"], b[0].losses["loss"], rtol=1e-5)


def test_odd_extents_fall_back_per_segment(packages, images, monkeypatch):
    """(36, 20): pool2 is 9x5, so blocks 3+ run the plain path from pool2."""
    _, pst = packages
    content, _ = images
    starts = []
    real_extract = vgg_mod.extract_features
    monkeypatch.setattr(
        vgg_mod, "extract_features",
        lambda *a, **kw: starts.append(kw.get("start_block", 1)) or real_extract(*a, **kw),
    )
    plan = pst._plan(StylizeConfig(), (36, 20), ("conv4_2",), vgg_mod.DEFAULT_STYLE_LAYERS)
    feats, grams = pst._forward(plan, torch.from_numpy(content[:36, :20])[None])
    assert starts == [3]
    assert set(grams) == {"conv1_1", "conv2_1"}
    assert set(feats) == {"conv3_1", "conv4_1", "conv4_2", "conv5_1"}


def test_init_modes_and_outputs(packages, images):
    _, pst = packages
    content, style = images
    kw = dict(size=(16, 16), min_scale=16, iterations=(1,),
              content_layers=("conv2_2",), style_layers=("conv1_1", "conv2_1"))
    r1 = pst.stylize(content, style, StylizeConfig(init="random", seed=3, **kw))
    r2 = pst.stylize(content, style, StylizeConfig(init="random", seed=3, **kw))
    np.testing.assert_array_equal(r1, r2)
    m = pst.stylize(content, style, StylizeConfig(init="mean", **kw))
    u8 = pst.stylize(content, style, StylizeConfig(init="mean", **kw), output_dtype="uint8")
    assert u8.dtype == np.uint8 and u8.shape == m.shape == (16, 16, 3)
    np.testing.assert_array_equal(u8, (np.clip(m, 0, 1) * 255 + 0.5).astype(np.uint8))
    avg = pst.stylize(content, style, StylizeConfig(avg_decay=0.5, **kw))
    assert np.isfinite(avg).all()
    init = pst.stylize(content, style, StylizeConfig(**kw), init_image=style)
    assert init.shape == (16, 16, 3)


def test_bad_arguments_raise(packages, images):
    _, pst = packages
    content, style = images
    kw = dict(size=(16, 16), min_scale=16, iterations=(1,))
    with pytest.raises(ValueError, match="init mode"):
        pst.stylize(content, style, StylizeConfig(init="zeros", **kw))
    with pytest.raises(ValueError, match="blend weights"):
        pst.stylize(content, [style, style], StylizeConfig(style_blend_weights=[1.0], **kw))
    with pytest.raises(ValueError, match="output_dtype"):
        pst.stylize(content, style, StylizeConfig(**kw), output_dtype="float16")
    with pytest.raises(ValueError, match="at least one style"):
        pst.stylize(content, [], StylizeConfig(**kw))
    with pytest.raises(ValueError, match="unknown optimizer"):
        pst.stylize(content, style, StylizeConfig(optimizer=OptimizerSpec("sgd"), **kw))
    with pytest.warns(UserWarning, match="rounded to"):
        pst.stylize(content, style, StylizeConfig(size=(17, 16), min_scale=16, iterations=(1,),
                                                  content_layers=("conv1_2",),
                                                  style_layers=("conv1_1",)))


def test_chain_on_the_card_refuses_a_non_bf16_compute_dtype():
    """The gate alone: a StyleTransfer that says it is on CUDA with an fp32
    compute dtype raises for the fused chain instead of taking the plain
    path; ``use_fused=False`` stays the plain route, and the CPU runs the
    chain in fp32. (The launch on a real card is in test_torch_cuda.py.)"""
    st = StyleTransfer(device="cpu")
    assert st._fused(StylizeConfig())
    st.device = torch.device("cuda")
    with pytest.raises(ValueError, match="bf16"):
        st._build_objective(StylizeConfig())
    assert not st._fused(StylizeConfig(use_fused=False))
    st.compute_dtype = torch.bfloat16
    assert st._fused(StylizeConfig())


def test_defaults_pick_device_and_dtype():
    st = StyleTransfer(device="cpu")
    assert st.compute_dtype == torch.float32 and st.arch == "vgg19"
    assert st.params["conv5_1"]["kernel"].device.type == "cpu"
    cfg = StylizeConfig()
    assert (cfg.size, cfg.min_scale, cfg.tv_weight, cfg.style_weight) == (512, 256, 2.0, 256.0)
    assert cfg.content_layers == ("conv4_2",) and cfg.style_layers[-1] == "conv5_1"
