"""The port's four kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version (a CPU tensor
never reaches a CUDA kernel); the JAX kernels run in interpret mode, as the
JAX package's own tests run them. Forward outputs and the input cotangent
for a random cotangent on every output are compared in fp32 at rtol 1e-4,
atol 1e-5. The CUDA kernels themselves are held against the plain versions
on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import block1_packed as JB1
from style_transfer_tpu.ops.pallas import block2 as JB2
from style_transfer_tpu.ops.pallas import conv_gram as JCG
from style_transfer_tpu.ops.pallas import conv_pair as JCP
from style_transfer_tpu.ops.pallas import epilogue as JEP
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import epilogue as EP

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _conv_weights(rng, cin, cout):
    k = (rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    return k, b


def _case(name, seed=0):
    """(jax_fn, torch_fn, x, cotangent shapes) for one kernel contract, with
    inputs drawn from numpy for both packages."""
    rng = np.random.RandomState(seed)
    if name == "pair_gram":
        x = rng.rand(1, 10, 14, 16).astype(np.float32)
        w = _conv_weights(rng, 16, 32) + _conv_weights(rng, 32, 32)
        return JCP.pair_gram, CP.pair_gram, x, w, [(1, 10, 14, 32), (32, 32)]
    if name == "pair_pool":
        x = rng.rand(1, 12, 8, 16).astype(np.float32)
        w = _conv_weights(rng, 16, 16) + _conv_weights(rng, 16, 16)
        return JCP.pair_pool, CP.pair_pool, x, w, [(1, 6, 4, 16)]
    if name == "block2_fused":
        x = rng.rand(1, 8, 12, 64).astype(np.float32)
        w = _conv_weights(rng, 64, 128) + _conv_weights(rng, 128, 128)
        return JB2.block2_fused, B2.block2_fused, x, w, [(1, 4, 6, 128), (128, 128)]
    if name == "conv_gram":
        x = rng.rand(1, 6, 8, 32).astype(np.float32)
        w = _conv_weights(rng, 32, 32)
        return JCG.conv_gram, CG.conv_gram, x, w, [(32, 32)]
    if name == "block1_packed":
        x = rng.randn(1, 8, 12, 3).astype(np.float32)
        w = _conv_weights(rng, 3, 64) + _conv_weights(rng, 64, 64)
        return JB1.block1_packed, B1.block1_packed, x, w, [(1, 4, 6, 64), (64, 64)]
    if name == "tv_loss":
        x = rng.rand(1, 20, 18, 3).astype(np.float32)
        return JEP.tv_loss, EP.tv_loss, x, (), [()]
    raise KeyError(name)


CASES = ["pair_gram", "pair_pool", "block2_fused", "conv_gram", "block1_packed", "tv_loss"]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_jax_kernel(name):
    jfn, tfn, x, w, ct_shapes = _case(name)
    rng = np.random.RandomState(100)
    cts = [np.asarray(rng.randn(*s), np.float32) for s in ct_shapes]

    j_out, vjp = jax.vjp(lambda xx: jfn(xx, *w), x)
    j_out = _as_tuple(j_out)
    (j_dx,) = vjp(tuple(cts) if len(cts) > 1 else cts[0])

    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = _as_tuple(tfn(xt, *[torch.from_numpy(a) for a in w]))
    (t_dx,) = torch.autograd.grad(t_out, xt, grad_outputs=[torch.from_numpy(c) for c in cts])

    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "jfn, tfn, shape",
    [(JB2.block2_fused, B2.block2_fused, (1, 8, 12, 32)),
     (JB2.block2_fused, B2.block2_fused, (1, 7, 12, 64)),
     (JB1.block1_packed, B1.block1_packed, (1, 8, 11, 3)),
     (JB1.block1_packed, B1.block1_packed, (2, 8, 12, 3))],
)
def test_input_checks_match_jax(jfn, tfn, shape):
    """The shapes the JAX wrappers refuse are refused here too."""
    with pytest.raises(ValueError):
        jfn(np.zeros(shape, np.float32), *([np.zeros(1, np.float32)] * 4))
    with pytest.raises(ValueError):
        tfn(torch.zeros(shape), *([torch.zeros(1)] * 4))
