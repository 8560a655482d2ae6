"""The large-image route of the port's chain: singles and ``gram_tail``.

With ``dispatch.PAIR_EFF_LIMIT`` lowered to 16 (the limit of both the
segment rule and the conv_gram range), a 32x64 image at full VGG-19 widths
takes the route a 2048 px-wide image takes at the real limit: every
two-conv segment as two singles, conv5_1 through ``gram_tail``. A spy shows
that those wrappers carried the objective and the captures and the pair
wrappers did not; the fused objective's loss terms and image gradient then
match the port's plain path (``use_fused=False``) and the JAX package's fp32
objective, fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch.models import vgg as vgg_mod
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import dispatch

torch.set_num_threads(2)

SIZE = (32, 64)
RTOL = 1e-4


@pytest.fixture(scope="module")
def packages(tiny_params):
    jparams, mean, std = tiny_params
    jst = JStyleTransfer(jparams, mean=mean, std=std)
    pst = StyleTransfer(from_numpy_params(jparams), mean=mean, std=std, device="cpu")
    return jst, pst


@pytest.fixture(scope="module")
def images():
    r = np.random.RandomState(7)
    content = r.rand(*SIZE, 3).astype(np.float32)
    style = r.rand(*SIZE, 3).astype(np.float32)
    image = np.clip(content + 0.05 * r.randn(*SIZE, 3), 0, 1).astype(np.float32)[None]
    return content, style, image


def _port_objective(pst, cfg, content, style, image):
    """Loss terms and image gradient of the port's objective for ``cfg``,
    with targets captured the same way."""
    c_t = pst._capture_content(cfg, torch.from_numpy(content)[None])
    s_t = pst._capture_style(cfg, torch.from_numpy(style)[None])
    x = torch.from_numpy(image).requires_grad_(True)
    loss, terms = pst._build_objective(cfg)(x, c_t, s_t)
    (grad,) = torch.autograd.grad(loss, x)
    return {k: float(v.detach()) for k, v in terms.items()}, grad.numpy()


def _jax_objective(jst, content, style, image):
    """The JAX package's plain fp32 objective (``use_fused=False``)."""
    jcfg = JStylizeConfig(size=SIZE, use_fused=False)
    c_weights = JL.normalize_layer_weights(jcfg.content_layers)
    s_weights = JL.normalize_layer_weights(jcfg.style_layers)
    all_layers = tuple(dict.fromkeys(list(jcfg.content_layers) + list(jcfg.style_layers)))
    c_t = jst._features(jst.params, jnp.asarray(content)[None], jcfg.content_layers)
    s_t = {k: JL.gram_matrix(v)
           for k, v in jst._features(jst.params, jnp.asarray(style)[None], jcfg.style_layers).items()}
    objective = jst._build_objective(
        jcfg, c_weights=c_weights, s_weights=s_weights, all_layers=all_layers,
        gram_fn=JL.gram_matrix, loss_fns={}, fused_b1=False, packed_b1=False,
        packed_b2=False, packed_b3=False, packed_b4=False,
    )
    (_, terms), grad = jax.value_and_grad(
        lambda im: objective(jst.params, im, c_t, s_t), has_aux=True
    )(jnp.asarray(image))
    return {k: float(v) for k, v in terms.items()}, np.asarray(grad)


def test_large_route_runs_singles_and_gram_tail_and_matches(packages, images, monkeypatch):
    jst, pst = packages
    content, style, image = images
    monkeypatch.setattr(dispatch, "PAIR_EFF_LIMIT", 16)
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in [(CS, "single_gram"), (CS, "single_plain"), (CS, "single_pool"),
                         (CS, "gram_tail"), (CP, "pair_gram"), (CP, "pair_pool"),
                         (B2, "block2_fused"), (CG, "conv_gram")]:
        spy(module, name)
    real_extract = vgg_mod.extract_features

    def spy_extract(*a, **kw):
        assert kw.get("start_block", 1) == 1, "objective fell back to extract_features mid-chain"
        return real_extract(*a, **kw)

    monkeypatch.setattr(vgg_mod, "extract_features", spy_extract)

    cfg = StylizeConfig(size=SIZE)
    fused_terms, fused_grad = _port_objective(pst, cfg, content, style, image)

    # A pass through the block-4 tail runs 3 gram singles (block 2 and the
    # block-3/4 fronts), 3 pool singles (block 2 and the block-3/4 tails) and
    # 4 plain ones (second conv of each block-3/4 front, first of each
    # block-3/4 tail); the style capture and the objective make two such
    # passes, the content capture stops at conv4_2 (no block-4 tail).
    assert calls["gram_tail"] == 2
    assert calls["single_gram"] == 3 + 3 + 3
    assert calls["single_pool"] == 2 + 3 + 3
    assert calls["single_plain"] == 3 + 4 + 4
    for pair_wrapper in ("pair_gram", "pair_pool", "block2_fused", "conv_gram"):
        assert pair_wrapper not in calls, pair_wrapper

    plain_terms, plain_grad = _port_objective(
        pst, StylizeConfig(size=SIZE, use_fused=False), content, style, image
    )
    jax_terms, jax_grad = _jax_objective(jst, content, style, image)
    scale = np.abs(jax_grad).max()
    for ref_terms, ref_grad in ((plain_terms, plain_grad), (jax_terms, jax_grad)):
        for k in ("loss", "content", "style", "tv"):
            np.testing.assert_allclose(fused_terms[k], ref_terms[k], rtol=RTOL)
        np.testing.assert_allclose(fused_grad, ref_grad, rtol=RTOL, atol=RTOL * scale)


def test_real_limit_keeps_pairs_at_this_size(packages, images, monkeypatch):
    """At the real limit the same image takes the pairs and conv_gram."""
    _, pst = packages
    content, _, _ = images
    calls = []
    for module, name in [(CS, "gram_tail"), (CS, "single_gram"), (CP, "pair_gram"),
                         (CG, "conv_gram")]:
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    with torch.no_grad():
        pst._chain_features(torch.from_numpy(content)[None], ("conv4_2",),
                            vgg_mod.DEFAULT_STYLE_LAYERS)
    assert sorted(set(calls)) == ["conv_gram", "pair_gram"]
