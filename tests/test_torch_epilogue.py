"""The port's fused content and style losses against the JAX package's
Pallas epilogues (``ops/pallas/epilogue.py``, interpret mode off the TPU).

On the CPU the port's wrappers run their plain versions. Value, the gradient
to the first argument for a random scalar cotangent, and no gradient to the
second, in fp32 at rtol 1e-4, atol 1e-6. The CUDA kernel itself is held to
the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import epilogue as JEP
from style_transfer_tpu_torch.ops.kernels import epilogue as EP

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6


def _compare(jfn, tfn, a, b, ct):
    j_val, vjp = jax.vjp(lambda aa: jfn(aa, b), a)
    (j_da,) = vjp(np.float32(ct))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    t_val = tfn(ta, tb)
    t_da, t_db = torch.autograd.grad(t_val, (ta, tb), grad_outputs=torch.tensor(ct),
                                     allow_unused=True)
    assert t_val.dtype == torch.float32 and t_val.shape == ()
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_da.numpy(), np.asarray(j_da), rtol=RTOL, atol=ATOL)
    assert t_db is None  # the target is a constant capture, as in the reference's VJP


# the second shape has M = 1*5*7 = 35 rows, not a multiple of 8
@pytest.mark.parametrize("shape", [(1, 8, 12, 16), (1, 5, 7, 24)])
def test_content_loss_matches_jax_kernel(shape):
    rng = np.random.RandomState(0)
    feat = rng.rand(*shape).astype(np.float32)
    target = rng.rand(*shape).astype(np.float32)
    _compare(JEP.content_loss, EP.content_loss, feat, target, 0.7)


@pytest.mark.parametrize("c", [8, 64])
def test_style_loss_matches_jax_kernel(c):
    rng = np.random.RandomState(1)
    gram = rng.randn(c, c).astype(np.float32)
    target = rng.randn(c, c).astype(np.float32)
    _compare(JEP.style_loss, EP.style_loss, gram, target, 1.3)


@pytest.mark.parametrize("tfn, shape", [(EP.content_loss, (1, 4, 6, 8)), (EP.style_loss, (8, 8))])
def test_target_gets_no_gradient_from_the_kernel_function(tfn, shape):
    """The autograd Function behind the CUDA wrapper returns None for the
    target (the reference's VJP does): shown on its backward directly, since
    a CPU tensor takes the plain version."""

    class Ctx:
        saved_tensors = (torch.ones(shape),)

    grads = EP._SseFunction.backward(Ctx, torch.tensor(0.5))
    assert grads[1] is None and grads[2] is None
    np.testing.assert_allclose(grads[0].numpy(), np.full(shape, 2 * 0.5 / np.prod(shape)),
                               rtol=1e-6)
    assert tfn(torch.zeros(shape), torch.zeros(shape)).item() == 0.0


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="differ"):
        EP.content_loss(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 16))
    with pytest.raises(ValueError, match="differ"):
        EP.style_loss(torch.zeros(8, 8), torch.zeros(16, 16))
