"""The port's single-conv module against the JAX package's Pallas kernels.

Every form of ``ops/pallas/conv_single.py`` — the three named singles, both
epilogues at once, a Gram column window, an odd H, ``gram_tail``, the pair
of singles for each epilogue pair, and the W-sliced single and pair with a
forced slice count on a width that does not split evenly — against its
counterpart in ``style_transfer_tpu_torch/ops/kernels/conv_single.py``. On
the CPU the port runs its plain PyTorch versions; the JAX kernels run in
interpret mode, as ``tests/test_conv_single.py`` runs them. Forward outputs
and the input cotangent for a random cotangent on every output are compared
in fp32 at rtol 1e-4, atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import conv_single as JCS
from style_transfer_tpu_torch.ops.kernels import conv_single as CS

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _conv_weights(rng, cin, cout):
    k = (rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    return k, b


# name -> (jax fn, port fn, x shape, conv channel steps, pool, gram); a
# pair's weights are two convs, cin -> cout -> cout
CASES = {
    "single_plain": (JCS.single_plain, CS.single_plain, (1, 10, 14, 32), 1, False, False),
    "single_gram": (JCS.single_gram, CS.single_gram, (1, 12, 8, 16), 1, False, True),
    "single_pool": (JCS.single_pool, CS.single_pool, (1, 12, 8, 32), 1, True, False),
    "single_pool_gram": (JCS.make_conv_single(pool=True, gram=True),
                         CS.make_conv_single(pool=True, gram=True), (1, 8, 12, 16), 1, True, True),
    "gram_cols_2_9": (JCS.make_conv_single(pool=False, gram=True, gram_cols=(2, 9)),
                      CS.make_conv_single(pool=False, gram=True, gram_cols=(2, 9)),
                      (1, 10, 12, 16), 1, False, True),
    "odd_h": (JCS.single_gram, CS.single_gram, (1, 11, 10, 16), 1, False, True),
    "gram_tail": (JCS.gram_tail, CS.gram_tail, (1, 6, 10, 32), 1, None, True),
    **{
        f"pair_of_singles_pool{int(p)}_gram{int(g)}": (
            JCS.make_pair_of_singles(pool=p, gram=g), CS.make_pair_of_singles(pool=p, gram=g),
            (1, 8, 12, 16), 2, p, g,
        )
        for p in (False, True) for g in (False, True)
    },
    # W splits unevenly in both. Three slices need W > 32: the reference
    # rounds the owned width up to 16 columns, and below that its middle
    # slice's Gram window covers zero-padded columns beyond the image
    # (ROADMAP.md, faults; test_wide_forms_stitch_to_the_single).
    **{
        f"wide_single_slices{n}": (
            JCS.make_wide_single(pool=True, gram=True, slices=n),
            CS.make_wide_single(pool=True, gram=True, slices=n), (1, h, w, 16), 1, True, True,
        )
        for n, h, w in ((2, 6, 22), (3, 4, 40))
    },
    **{
        f"wide_pair_slices{n}": (
            JCS.make_wide_pair_of_singles(pool=True, gram=True, slices=n),
            CS.make_wide_pair_of_singles(pool=True, gram=True, slices=n),
            (1, 4, w, 16), 2, True, True,
        )
        for n, w in ((2, 22), (3, 40))
    },
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_kernel(name):
    jfn, tfn, shape, nconv, pool, gram = CASES[name]
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    _, h, w, cin = shape
    cout = 32
    weights = list(_conv_weights(rng, cin, cout))
    if nconv == 2:
        weights += _conv_weights(rng, cout, cout)
    ct_shapes = []
    if pool is not None:  # gram_tail has no activation output
        ct_shapes.append((1, h // 2, w // 2, cout) if pool else (1, h, w, cout))
    if gram:
        ct_shapes.append((cout, cout))
    ct_rng = np.random.RandomState(100)
    cts = [np.asarray(ct_rng.randn(*s), np.float32) for s in ct_shapes]

    j_out, vjp = jax.vjp(lambda xx: jfn(xx, *weights), x)
    j_out = _as_tuple(j_out)
    (j_dx,) = vjp(tuple(cts) if len(cts) > 1 else cts[0])

    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = _as_tuple(tfn(xt, *[torch.from_numpy(a) for a in weights]))
    (t_dx,) = torch.autograd.grad(t_out, xt, grad_outputs=[torch.from_numpy(c) for c in cts])

    assert len(t_out) == len(j_out) == len(cts)
    for t, j in zip(t_out, j_out):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=RTOL, atol=ATOL)


def test_wide_forms_stitch_to_the_single():
    """``slices=None`` (and 1) runs the unsliced single, and every forced
    slice count gives its values — also where the last slices own no column
    of the image (W=22 in 8 slices of 4 owned columns), the case in which
    the reference's Gram counts the zero-padded surplus."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(1, 6, 22, 16).astype(np.float32))
    k, b = (torch.from_numpy(a) for a in _conv_weights(rng, 16, 32))
    ref_out, ref_g = CS.make_conv_single(pool=True, gram=True)(x, k, b)
    for slices in (None, 1, 2, 3, 8):
        out, g = CS.make_wide_single(pool=True, gram=True, slices=slices)(x, k, b)
        np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), ref_g.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 7, 12, 16), (1, 8, 11, 16), (2, 8, 12, 16)])
def test_input_checks_match_jax(shape):
    """The shapes the JAX single refuses with pooling are refused here too."""
    x = np.zeros(shape, np.float32)
    k, b = np.zeros((3, 3, 16, 16), np.float32), np.zeros(16, np.float32)
    with pytest.raises(ValueError):
        JCS.single_pool(x, k, b)
    with pytest.raises(ValueError):
        CS.single_pool(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
