"""The port's streaming Gram against the JAX package's ``pallas_gram``
(``ops/pallas/gram.py``, interpret mode off the TPU), and the channel-set
dispatch of ``gram_matrix`` on both sides.

On the CPU the port's wrapper runs its plain version; value and VJP in fp32
at rtol 1e-4, atol 1e-6. The CUDA kernel is held to the plain version on the
card by ``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import gram as JG
from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.ops.kernels import gram as KG

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6


# M = N*H*W: 35 and 2*9*11 = 198, neither a multiple of the TPU row tile
@pytest.mark.parametrize("shape", [(1, 5, 7, 16), (2, 9, 11, 32), (1, 8, 8, 64)])
def test_pallas_gram_matches_jax_kernel(shape):
    rng = np.random.RandomState(0)
    feat = rng.randn(*shape).astype(np.float32)
    ct = rng.randn(shape[-1], shape[-1]).astype(np.float32)
    j_g, vjp = jax.vjp(JG.pallas_gram, feat)
    (j_df,) = vjp(ct)
    tf = torch.from_numpy(feat).requires_grad_(True)
    t_g = KG.pallas_gram(tf)
    (t_df,) = torch.autograd.grad(t_g, tf, grad_outputs=torch.from_numpy(ct))
    assert t_g.dtype == torch.float32 and tuple(t_g.shape) == tuple(j_g.shape)
    np.testing.assert_allclose(t_g.detach().numpy(), np.asarray(j_g), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_df.numpy(), np.asarray(j_df), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [frozenset(), frozenset({16}), frozenset({16, 32})])
def test_gram_matrix_dispatches_by_the_channel_set(channels, monkeypatch):
    """With each side's set patched to the same widths, both send exactly
    those widths to the streaming kernel and agree on every width."""
    monkeypatch.setattr(JG, "_PALLAS_CHANNELS", channels)
    monkeypatch.setattr(KG, "KERNEL_CHANNELS", channels)
    monkeypatch.setattr(KG, "KERNEL_MIN_ELEMENTS", 0)  # the port's own gate, below
    sent = {"jax": [], "torch": []}
    real_j, real_t = JG.pallas_gram, KG.pallas_gram
    monkeypatch.setattr(JG, "pallas_gram", lambda f: sent["jax"].append(f.shape[-1]) or real_j(f))
    monkeypatch.setattr(KG, "pallas_gram", lambda f: sent["torch"].append(f.shape[-1]) or real_t(f))
    rng = np.random.RandomState(3)
    for c in (8, 16, 32):
        feat = rng.rand(1, 6, 10, c).astype(np.float32)
        np.testing.assert_allclose(KG.gram_matrix(torch.from_numpy(feat)).numpy(),
                                   np.asarray(JG.gram_matrix(feat)), rtol=RTOL, atol=ATOL)
    assert sent["jax"] == sent["torch"] == sorted(channels)


def test_channel_set_is_read_at_call_time(monkeypatch):
    feat = torch.rand(1, 4, 4, 8)
    calls = []
    monkeypatch.setattr(KG, "pallas_gram", lambda f: calls.append(1) or L.gram_matrix(f))
    monkeypatch.setattr(KG, "KERNEL_MIN_ELEMENTS", 128)
    KG.gram_matrix(feat)
    monkeypatch.setattr(KG, "KERNEL_CHANNELS", frozenset({8}))
    KG.gram_matrix(feat)
    assert calls == [1]


@pytest.mark.parametrize("rows, sent", [(15, 0), (16, 1), (32, 1)])
def test_gram_matrix_keeps_small_activations_off_the_kernel(rows, sent, monkeypatch):
    """A width of the set goes to the kernel only from ``KERNEL_MIN_ELEMENTS``
    elements (rows * 8 here) on; the value is the plain Gram either way."""
    feat = torch.rand(1, 1, rows, 8)
    calls = []
    monkeypatch.setattr(KG, "pallas_gram", lambda f: calls.append(1) or L.gram_matrix(f))
    monkeypatch.setattr(KG, "KERNEL_CHANNELS", frozenset({8}))
    monkeypatch.setattr(KG, "KERNEL_MIN_ELEMENTS", 128)
    g = KG.gram_matrix(feat)
    assert len(calls) == sent
    np.testing.assert_allclose(g.numpy(), L.gram_matrix(feat).numpy(), rtol=RTOL, atol=ATOL)


def test_pallas_gram_wants_nhwc():
    with pytest.raises(ValueError, match="N, H, W, C"):
        KG.pallas_gram(torch.zeros(16, 8))
    with pytest.raises(ValueError):
        JG.pallas_gram(np.zeros((16, 8), np.float32))


def test_gram_function_on_the_card_refuses_other_dtypes():
    """The kernel path takes bf16 only; shown on the Function directly (a
    CPU tensor never reaches it through the wrapper)."""
    with pytest.raises(ValueError, match="bf16"):
        KG.GramFunction.apply(torch.zeros(1, 4, 4, 64))
