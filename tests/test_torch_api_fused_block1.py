"""The opt-in objective as a whole: ``StylizeConfig(fused_block1=True)`` and
``objective_terms`` with its four fused hooks, against the JAX package.

Both packages use the JAX fixture weights and the same numpy images, fp32 on
the CPU, where the port's wrappers run their plain versions and the JAX
package's Pallas kernels (``block1_full``, ``pallas_gram``, the content,
style and TV epilogues) run in interpret mode. Post-Adam pixels are not
compared (ROADMAP.md); losses and gradients are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.models import vgg as jvgg
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.ops.pallas import block1 as JB1
from style_transfer_tpu.ops.pallas import epilogue as JEP
from style_transfer_tpu.ops.pallas import gram as JG
from style_transfer_tpu.optim import OptimizerSpec as JOptimizerSpec
from style_transfer_tpu.utils import imgio as jimgio
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch.models import vgg as vgg_mod
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.ops.kernels import gram as KG
from style_transfer_tpu_torch.optim import OptimizerSpec
from style_transfer_tpu_torch.utils import imgio

torch.set_num_threads(2)

CONTENT = ("conv4_2",)
STYLE = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")


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


def test_fused_block1_loss_curve_matches_jax(packages, images):
    """Two-scale ladder (32 -> 64), three Adam steps each, the flag set on
    both sides: per-step loss terms at rtol 1e-4."""
    jst, pst = packages
    content, style = images
    kw = dict(size=64, min_scale=32, iterations=(3,), chunk_size=3, fused_block1=True)
    jev, pev = [], []
    jout = jst.stylize(
        content, style,
        JStylizeConfig(warm_compile=False, optimizer=JOptimizerSpec("adam", learning_rate=0.05), **kw),
        callback=jev.append,
    )
    pout = pst.stylize(
        content, style,
        StylizeConfig(optimizer=OptimizerSpec("adam", learning_rate=0.05), **kw),
        callback=pev.append,
    )
    assert [e.size for e in pev] == [e.size for e in jev] == [(32, 24), (64, 48)]
    for pe, je in zip(pev, jev):
        for k in ("loss", "content", "style", "tv"):
            np.testing.assert_allclose(pe.losses[k], je.losses[k], rtol=1e-4, atol=1e-9)
    assert pout.shape == jout.shape == (64, 48, 3)
    assert np.isfinite(pout).all() and pout.min() >= 0.0 and pout.max() <= 1.0


def _spy(monkeypatch, calls, module, name):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


def test_block1_full_carries_the_path_and_the_chain_does_not(packages, images, monkeypatch):
    _, pst = packages
    content, style = images
    calls, starts = {}, []
    for module, name in [(B1, "block1_full"), (B1, "block1_packed"), (B2, "block2_fused"),
                         (CP, "pair_gram"), (CP, "pair_pool"), (CG, "conv_gram"),
                         (EP, "tv_loss"), (KG, "gram_matrix")]:
        _spy(monkeypatch, calls, module, name)
    real_extract = vgg_mod.extract_features
    monkeypatch.setattr(
        vgg_mod, "extract_features",
        lambda *a, **kw: starts.append(kw.get("start_block", 1)) or real_extract(*a, **kw),
    )
    steps = 2
    pst.stylize(content, style,
                StylizeConfig(size=(64, 48), min_scale=64, iterations=(steps,), fused_block1=True))
    # one objective per step, plus the content and the style capture
    assert calls["block1_full"] == steps + 2
    assert starts == [2] * (steps + 2)
    assert calls["tv_loss"] == steps
    # conv2_1..conv5_1 materialize and go through gram_fn: every step and the style capture
    assert calls["gram_matrix"] == 4 * (steps + 1)
    for name in ("block1_packed", "block2_fused", "pair_gram", "pair_pool", "conv_gram"):
        assert name not in calls, name


def test_fused_block1_gates(packages):
    """The flag needs use_fused and the structural gate; set, it switches the
    chain off whether or not block1_full engages; odd extents run plain."""
    _, pst = packages

    def route(st, hw=(32, 32), **kw):
        cfg = StylizeConfig(**kw)
        return st._plan(cfg, hw, cfg.content_layers, cfg.style_layers).route

    full, plain = ("block1", "block1_full"), (("vgg", "plain"),)
    assert route(pst, fused_block1=True)[0] == full
    assert route(pst)[0] == ("block1", "pair")
    assert route(pst, fused_block1=True, use_fused=False) == plain
    assert route(pst, fused_block1=True, content_layers=("conv1_2",)) == plain
    assert route(pst, use_fused=False) == plain
    mx = StyleTransfer(pst.params, mean=pst.mean, std=pst.std, pooling="max", device="cpu")
    assert route(mx, fused_block1=True) == plain
    cfg = StylizeConfig(fused_block1=True, content_layers=("conv2_2",), style_layers=("conv1_1",))
    plan = pst._plan(cfg, (18, 17), ("conv2_2",), ("conv1_1",))
    feats, grams = pst._forward(plan, torch.rand(1, 18, 17, 3))
    assert plan.route == plain and grams == {} and set(feats) == {"conv2_2", "conv1_1"}
    plan = pst._plan(cfg, (18, 16), (), ("conv1_1",))  # the style capture's plan
    feats, grams = pst._forward(plan, torch.rand(1, 18, 16, 3))
    assert plan.route == (full,) and feats == {} and set(grams) == {"conv1_1"}


def _weights(st, *names):
    return [t for n in names for t in (st.params[n]["kernel"], st.params[n]["bias"])]


@pytest.mark.parametrize("block1", ["full", "tail"])
def test_objective_with_all_four_hooks_matches_jax(packages, images, block1):
    """``objective_terms`` with the Gram kernel and the three fused losses on
    both sides, block 1 as ``block1_full`` or as conv1_1 + ``block1_tail``:
    loss terms at rtol 1e-4 and the image gradient at rtol 1e-3."""
    jst, pst = packages
    content, style = images
    content, style = content[:32, :24], style[:24, :32]
    image = np.clip(
        content + 0.05 * np.random.RandomState(5).randn(*content.shape), 0, 1
    ).astype(np.float32)[None]
    layers = CONTENT + STYLE
    deeper = tuple(l for l in layers if l != "conv1_1")
    c_w = {l: 1.0 / len(CONTENT) for l in CONTENT}
    s_w = {l: 1.0 / len(STYLE) for l in STYLE}
    weights = dict(content_weight=1.0, style_weight=256.0, tv_weight=2.0)

    def j_feats(im):
        x = jimgio.preprocess(im, jst.mean, jst.std)
        p1, p2 = jst.params["conv1_1"], jst.params["conv1_2"]
        if block1 == "full":
            pool1, g1 = JB1.block1_full(x, p1["kernel"], p1["bias"], p2["kernel"], p2["bias"])
        else:
            r1 = jvgg.extract_features(jst.params, x, ("conv1_1",), shard_divisor=None)["conv1_1"]
            pool1, g1 = JB1.block1_tail(r1, p2["kernel"], p2["bias"])
        feats = jvgg.extract_features(jst.params, pool1, deeper, shard_divisor=None, start_block=2)
        return feats, g1

    def j_objective(im, c_t, s_t):
        feats, g1 = j_feats(im)
        return JL.objective_terms(
            feats, gram_overrides={"conv1_1": g1}, content_targets=c_t, style_targets=s_t,
            content_layer_weights=c_w, style_layer_weights=s_w, image=im,
            gram_fn=JG.pallas_gram, content_loss_fn=JEP.content_loss,
            style_loss_fn=JEP.style_loss, tv_loss_fn=JEP.tv_loss, **weights)

    def t_feats(im):
        x = imgio.preprocess(im, pst.mean, pst.std)
        if block1 == "full":
            pool1, g1 = B1.block1_full(x, *_weights(pst, "conv1_1", "conv1_2"))
        else:
            r1 = vgg_mod.extract_features(pst.params, x, ("conv1_1",))["conv1_1"]
            pool1, g1 = B1.block1_tail(r1, *_weights(pst, "conv1_2"))
        return vgg_mod.extract_features(pst.params, pool1, deeper, start_block=2), g1

    def t_objective(im, c_t, s_t):
        feats, g1 = t_feats(im)
        return L.objective_terms(
            feats, gram_overrides={"conv1_1": g1}, content_targets=c_t, style_targets=s_t,
            content_layer_weights=c_w, style_layer_weights=s_w, image=im,
            gram_fn=KG.pallas_gram, content_loss_fn=EP.content_loss,
            style_loss_fn=EP.style_loss, tv_loss_fn=EP.tv_loss, **weights)

    jf, _ = j_feats(jnp.asarray(content)[None])
    jc_t = {l: jf[l] for l in CONTENT}
    jf, jg1 = j_feats(jnp.asarray(style)[None])
    js_t = {l: jg1 if l == "conv1_1" else JG.pallas_gram(jf[l]) for l in STYLE}
    (jloss, jterms), jgrad = jax.value_and_grad(
        lambda im: (lambda t: (t["loss"], t))(j_objective(im, jc_t, js_t)), has_aux=True
    )(jnp.asarray(image))

    with torch.no_grad():
        tf, _ = t_feats(torch.from_numpy(content)[None])
        tc_t = {l: tf[l] for l in CONTENT}
        tf, tg1 = t_feats(torch.from_numpy(style)[None])
        ts_t = {l: tg1 if l == "conv1_1" else KG.pallas_gram(tf[l]) for l in STYLE}
    x = torch.from_numpy(image).requires_grad_(True)
    terms = t_objective(x, tc_t, ts_t)
    (grad,) = torch.autograd.grad(terms["loss"], x)

    for k in ("loss", "content", "style", "tv"):
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-3, atol=1e-6)


def test_default_device_is_the_card():
    """``StyleTransfer()`` runs on the GPU by default and raises where there
    is none, instead of carrying on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StyleTransfer()
    assert StyleTransfer(device="cpu").device.type == "cpu"
