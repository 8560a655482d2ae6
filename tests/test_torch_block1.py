"""The port's ``block1_tail`` and ``block1_full`` against the JAX package's
Pallas kernels (``ops/pallas/block1.py``, interpret mode off the TPU).

On the CPU the port's wrappers run their plain versions. pool1, the Gram and
the input gradient under random cotangents for both outputs, in fp32 at rtol
1e-4, atol 1e-5 (sums of 576 products in another order). Sizes: 20x24, whose
H is not a multiple of the TPU kernel's 16-row padding, and 8x12, narrower
than the CUDA kernel's 16-column tile. The CUDA kernels are held to the plain
versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import block1 as JB1
from style_transfer_tpu_torch.ops.kernels import block1 as B1

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
SIZES = [(20, 24), (8, 12)]


def _conv_weights(rng, cin, cout):
    k = (rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    return k, b


def _compare(jfn, tfn, x, w, h, wd):
    rng = np.random.RandomState(100)
    cts = [rng.randn(1, h // 2, wd // 2, 64).astype(np.float32),
           rng.randn(64, 64).astype(np.float32)]
    j_out, vjp = jax.vjp(lambda xx: jfn(xx, *w), x)
    j_dx = vjp(tuple(cts))[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = tfn(xt, *[torch.from_numpy(a) for a in w])
    (t_dx,) = torch.autograd.grad(t_out, xt, grad_outputs=[torch.from_numpy(c) for c in cts])
    assert len(t_out) == len(j_out) == 2
    for t, j in zip(t_out, j_out):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=RTOL, atol=ATOL)
    return t_out


@pytest.mark.parametrize("h, wd", SIZES)
def test_block1_full_matches_jax_kernel(h, wd):
    rng = np.random.RandomState(0)
    x = rng.randn(1, h, wd, 3).astype(np.float32)
    w = _conv_weights(rng, 3, 64) + _conv_weights(rng, 64, 64)
    _compare(JB1.block1_full, B1.block1_full, x, w, h, wd)


@pytest.mark.parametrize("h, wd", SIZES)
def test_block1_tail_matches_jax_kernel(h, wd):
    rng = np.random.RandomState(1)
    r1 = np.maximum(rng.randn(1, h, wd, 64), 0).astype(np.float32)
    w = _conv_weights(rng, 64, 64)
    _compare(JB1.block1_tail, B1.block1_tail, r1, w, h, wd)


def test_block1_full_equals_block1_packed_plain_version():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 12, 10, 3).astype(np.float32))
    w = [torch.from_numpy(a) for a in _conv_weights(rng, 3, 64) + _conv_weights(rng, 64, 64)]
    for a, b in zip(B1.block1_full(x, *w), B1.block1_plain(x, *w)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # and the tail, fed conv1_1's activation, gives the same block
    r1 = torch.relu(B1.vgg.conv3x3(x, w[0], w[1]))
    for a, b in zip(B1.block1_tail(r1, w[2], w[3]), B1.block1_plain(x, *w)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(1, 7, 12, 3), (1, 8, 11, 3), (2, 8, 12, 3), (1, 8, 12, 4)])
def test_block1_full_refuses_bad_shapes(shape):
    with pytest.raises(ValueError, match="block1_full expects"):
        B1.block1_full(torch.zeros(shape), *([torch.zeros(1)] * 4))


@pytest.mark.parametrize("shape", [(1, 7, 12, 64), (1, 8, 11, 64), (2, 8, 12, 64), (1, 8, 12, 32)])
def test_block1_tail_refuses_bad_shapes(shape):
    with pytest.raises(ValueError, match="block1_tail expects"):
        B1.block1_tail(torch.zeros(shape), *([torch.zeros(1)] * 2))


def test_col2im_inverts_the_patch_layout():
    """The torch-side col2im of the kernel's tap-major patch cotangents is the
    transpose of the 3x3 SAME patch extraction: <patches(x), d> = <x, col2im(d)>."""
    rng = np.random.RandomState(4)
    h, w = 6, 10
    x = torch.from_numpy(rng.randn(h, w, 3).astype(np.float32))
    d = torch.from_numpy(rng.randn(9, h, w, 3).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([xp[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)])
    lhs = float((patches * d).sum())
    rhs = float((x * B1._col2im3(d)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_sym_is_the_scaled_symmetrized_cotangent():
    g = torch.arange(64.0 * 64).reshape(64, 64)
    s = B1._sym(g, 10, g)
    assert s.dtype == torch.bfloat16
    np.testing.assert_allclose(s.float().numpy(), ((g + g.T) / 10).bfloat16().float().numpy())
    assert not B1._sym(None, 10, g).any()
