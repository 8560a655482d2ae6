"""The port's loss module against the JAX package: values and autograd
gradients against ``jax.grad``, fp32 on the CPU, rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu_torch.ops import losses as L

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-7


def _arr(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _value_and_grad_torch(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    v = fn(*ts)
    grads = torch.autograd.grad(v, ts)
    return v.detach().numpy(), [g.numpy() for g in grads]


def _value_and_grad_jax(fn, *arrays):
    v, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays]
    )
    return np.asarray(v), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape", [(1, 5, 7, 8), (2, 3, 4, 16)])
def test_gram_matrix_value_and_grad(shape):
    f, w = _arr(*shape), _arr(shape[-1], shape[-1], seed=1)
    tv, tg = _value_and_grad_torch(lambda x, m: (L.gram_matrix(x) * m).sum(), f, w)
    jv, jg = _value_and_grad_jax(lambda x, m: (JL.gram_matrix(x) * m).sum(), f, w)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)
    g = L.gram_matrix(torch.from_numpy(f))
    assert g.dtype == torch.float32 and tuple(g.shape) == (shape[-1],) * 2
    np.testing.assert_allclose(g.numpy(), np.asarray(JL.gram_matrix(jnp.asarray(f))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "name, shapes",
    [
        ("tv_loss", [(1, 20, 18, 3)]),
        ("content_loss", [(1, 6, 5, 8), (1, 6, 5, 8)]),
        ("style_loss", [(16, 16), (16, 16)]),
    ],
)
def test_losses_value_and_grad(name, shapes):
    arrays = [_arr(*s, seed=i) for i, s in enumerate(shapes)]
    tv, tg = _value_and_grad_torch(getattr(L, name), *arrays)
    jv, jg = _value_and_grad_jax(getattr(JL, name), *arrays)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


def test_tv_gradient_zero_on_constant_image():
    x = torch.full((1, 6, 7, 3), 0.3, requires_grad=True)
    (g,) = torch.autograd.grad(L.tv_loss(x), x)
    assert float(g.abs().max()) == 0.0


def test_blend_grams_and_layer_weights():
    grams = [_arr(8, 8, seed=i) for i in range(3)]
    w = [0.5, 0.3, 1.2]
    np.testing.assert_allclose(
        L.blend_grams([torch.from_numpy(g) for g in grams], w).numpy(),
        np.asarray(JL.blend_grams([jnp.asarray(g) for g in grams], w)), rtol=RTOL, atol=ATOL,
    )
    layers = ("conv1_1", "conv2_1", "conv3_1")
    for weights in (None, [1.0, 2.0, 5.0]):
        assert L.normalize_layer_weights(layers, weights) == JL.normalize_layer_weights(layers, weights)
    with pytest.raises(ValueError, match="weights"):
        L.normalize_layer_weights(layers, [1.0])
    with pytest.raises(ValueError, match="positive"):
        L.normalize_layer_weights(layers, [0.0, 0.0, 0.0])


def test_objective_terms_value_and_grad():
    """All terms and the image gradient, with a Gram override standing in for
    a kernel-computed Gram, through both packages."""
    img = np.random.RandomState(7).rand(1, 8, 6, 3).astype(np.float32)
    fa, fb, over = _arr(1, 4, 3, 8, seed=1), _arr(1, 2, 2, 16, seed=2), _arr(8, 8, seed=3)
    ta, tb = _arr(1, 4, 3, 8, seed=4), _arr(16, 16, seed=5)
    t_over = _arr(8, 8, seed=6)
    kw = dict(content_layer_weights={"a": 1.0}, style_layer_weights={"b": 0.25, "c": 0.75},
              content_weight=1.5, style_weight=256.0, tv_weight=2.0)

    def jfn(img, fa, fb, over):
        return JL.objective_terms(
            {"a": fa, "b": fb}, content_targets={"a": ta}, style_targets={"b": tb, "c": t_over},
            image=img, gram_overrides={"c": over}, **kw)

    def tfn(img, fa, fb, over):
        return L.objective_terms(
            {"a": fa, "b": fb}, content_targets={"a": torch.from_numpy(ta)},
            style_targets={"b": torch.from_numpy(tb), "c": torch.from_numpy(t_over)},
            image=img, gram_overrides={"c": over}, **kw)

    arrays = (img, fa, fb, over)
    jterms = jfn(*[jnp.asarray(a) for a in arrays])
    tterms = tfn(*[torch.from_numpy(a) for a in arrays])
    assert set(tterms) == set(jterms) == {"loss", "content", "style", "tv"}
    for k in jterms:
        np.testing.assert_allclose(tterms[k].numpy(), np.asarray(jterms[k]), rtol=RTOL)
    _, tg = _value_and_grad_torch(lambda *a: tfn(*a)["loss"], *arrays)
    _, jg = _value_and_grad_jax(lambda *a: jfn(*a)["loss"], *arrays)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5)
