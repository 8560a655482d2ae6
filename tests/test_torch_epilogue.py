"""The port's fused content and style losses against the JAX package's
Pallas epilogues (``ops/pallas/epilogue.py``, interpret mode off the TPU).

On the CPU the port's wrappers run their plain versions. Value, the gradient
to the first argument for a random scalar cotangent, and no gradient to the
second, in fp32 at rtol 1e-4, atol 1e-6; ``content_loss`` also on bf16
inputs, where the gradient is rounded once to bf16 on both sides and may
differ by one bf16 step; ``tv_loss`` for a cotangent other than 1. The CUDA
kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py``.
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
    target (the reference's VJP does) and ``2 ct / numel`` times the
    difference for the first argument. Its backward launches a kernel, so
    this is shown on the plain backward that stands beside the kernel and
    has its bits (``sse_backward_plain``, and the chain ``scale_cast_plain``
    that it applies to the difference), and on the Function's backward with
    the launcher replaced by that plain version."""
    numel, ct = int(np.prod(shape)), torch.tensor(0.5)
    want = np.full(shape, 2 * 0.5 / numel)
    np.testing.assert_allclose(EP.scale_cast_plain(torch.ones(shape), ct, numel).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        EP.sse_backward_plain(ct, torch.full(shape, 3.0), torch.full(shape, 2.0)).numpy(), want, rtol=1e-6)

    class Ctx:
        saved_tensors = (torch.full(shape, 3.0), torch.full(shape, 2.0))
        count = EP.LaunchCount()

    def launcher(a, b, ct, *, count):
        return EP.sse_backward_plain(ct, a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EP._launch, "scale_cast", launcher)
        mp.setattr(EP._launch, "cotangent", lambda ct, device: ct)
        grads = EP._SseFunction.backward(Ctx, ct)
    assert grads[1] is None and grads[2] is None
    np.testing.assert_allclose(grads[0].numpy(), want, rtol=1e-6)
    assert tfn(torch.zeros(shape), torch.zeros(shape)).item() == 0.0


def _bf16_steps(a, b):
    """Largest distance between two bf16 arrays in steps of the bf16 grid
    (the ordered-integer distance of their bit patterns)."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("shape", [(1, 8, 12, 16), (1, 5, 7, 24)])
def test_content_loss_bf16_matches_jax_kernel(shape):
    """bf16 activations through the Pallas kernel (interpret mode) and
    through the port's plain path: the fp32 value at rtol 1e-4; the gradient
    is ``F - T`` rounded to bf16, scaled in fp32 and rounded to bf16 again on
    both sides, so it may differ by at most one bf16 step (where the two
    frameworks' autodiff forms the fp32 product in another order), and both
    lie within one step of the reference's chain ``sse_backward_plain``."""
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    feat32 = rng.rand(*shape).astype(np.float32)
    target32 = rng.rand(*shape).astype(np.float32)
    tf = torch.from_numpy(feat32).to(torch.bfloat16).requires_grad_(True)
    tt = torch.from_numpy(target32).to(torch.bfloat16)
    jf, jt = jnp.asarray(feat32).astype(jnp.bfloat16), jnp.asarray(target32).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(jf.astype(jnp.float32)), tf.detach().float().numpy())

    ct = 0.7
    j_val, vjp = jax.vjp(lambda aa: JEP.content_loss(aa, jt), jf)
    (j_da,) = vjp(np.float32(ct))
    t_val = EP.content_loss(tf, tt)
    (t_da,) = torch.autograd.grad(t_val, tf, grad_outputs=torch.tensor(ct))
    assert t_val.dtype == torch.float32 and t_da.dtype == torch.bfloat16 and j_da.dtype == jnp.bfloat16
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=RTOL, atol=ATOL)
    j_grad = torch.from_numpy(np.array(j_da.astype(jnp.float32))).to(torch.bfloat16)
    chain = EP.sse_backward_plain(torch.tensor(ct), tf.detach(), tt)
    assert _bf16_steps(t_da, j_grad) <= 1
    assert _bf16_steps(chain, j_grad) == 0  # the kernels' plain backward is the reference's chain
    assert _bf16_steps(chain, t_da) <= 1


@pytest.mark.parametrize("shape, ct", [((1, 20, 18, 3), 0.7), ((1, 5, 7, 3), -1.3), ((1, 9, 1, 3), 0.0)])
def test_tv_loss_with_a_cotangent_matches_jax_kernel(shape, ct):
    rng = np.random.RandomState(3)
    image = rng.rand(*shape).astype(np.float32)
    j_val, vjp = jax.vjp(JEP.tv_loss, image)
    (j_dx,) = vjp(np.float32(ct))
    x = torch.from_numpy(image).requires_grad_(True)
    t_val = EP.tv_loss(x)
    (t_dx,) = torch.autograd.grad(t_val, x, grad_outputs=torch.tensor(ct))
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=RTOL, atol=ATOL)
    # the plain backward beside the TV kernels is the reference's expression
    np.testing.assert_allclose(EP.tv_backward_plain(x.detach(), torch.tensor(ct)).numpy(),
                               np.asarray(j_dx), rtol=1e-6, atol=1e-9)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="differ"):
        EP.content_loss(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 16))
    with pytest.raises(ValueError, match="differ"):
        EP.style_loss(torch.zeros(8, 8), torch.zeros(16, 16))
