"""The kernel wrappers' weight-cotangent contract in the port, on the CPU.

Twin of ``tests/test_weight_grads.py``. The reference's custom-VJP kernels
differentiate w.r.t. the input only and return structural zeros for the VGG
weights. The port's CUDA ``Function``s return ``None`` for them, its PyTorch
form; on a CPU tensor every wrapper runs its plain version on detached
weights, so it gives ``None`` too, and the port agrees with itself from one
device to the other (``tests/test_torch_cuda.py`` checks the card). The
input gradient is untouched: it equals the JAX kernel's through the same
loss, and the plain VGG path (``models/vgg.extract_features``) still gives
true weight gradients, as JAX's ``extract_features`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import block1 as JB1
from style_transfer_tpu.ops.pallas import block1_packed as JB1P
from style_transfer_tpu.ops.pallas import conv_gram as JCG
from style_transfer_tpu.ops.pallas import conv_pair as JCP
from style_transfer_tpu.ops.pallas import conv_single as JCS
from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.parallel import mesh as M

MESH = M.make_mesh(devices=["cpu"] * 2)


def _w(r, cin, cout):
    return (r.randn(3, 3, cin, cout).astype(np.float32) * 0.05,
            r.randn(cout).astype(np.float32) * 0.1)


def _loss(out, sum_=torch.sum):
    if isinstance(out, tuple):
        y, g = out
        return _loss(y, sum_) + sum_(g ** 2)
    if isinstance(out, list):  # a sharded activation
        return sum(_loss(o, sum_) for o in out)
    return sum_(out ** 2)


# name -> (wrapper f(x, *weights), input (H, W, C), conv widths, sharded)
WRAPPERS = {
    "block1_packed": (B1.block1_packed, (8, 8, 3), [(3, 64), (64, 64)], False),
    "block1_full": (B1.block1_full, (8, 8, 3), [(3, 64), (64, 64)], False),
    "block1_tail": (B1.block1_tail, (8, 8, 64), [(64, 64)], False),
    "block2_fused": (B2.block2_fused, (8, 8, 64), [(64, 128), (128, 128)], False),
    "pair_gram": (CP.pair_gram, (8, 8, 64), [(64, 64), (64, 64)], False),
    "pair_pool": (CP.pair_pool, (8, 8, 64), [(64, 64), (64, 64)], False),
    "make_conv_pair": (CP.make_conv_pair(pool=True, gram=True), (8, 12, 64),
                       [(64, 64), (64, 64)], False),
    "conv_gram": (CG.conv_gram, (8, 8, 64), [(64, 64)], False),
    "single_plain": (CS.single_plain, (8, 8, 64), [(64, 64)], False),
    "single_gram": (CS.single_gram, (8, 8, 64), [(64, 64)], False),
    "single_pool": (CS.single_pool, (8, 8, 64), [(64, 64)], False),
    "make_conv_single": (CS.make_conv_single(pool=True, gram=True, gram_cols=(2, 6)),
                         (8, 8, 64), [(64, 64)], False),
    "gram_tail": (CS.gram_tail, (8, 8, 64), [(64, 64)], False),
    "make_pair_of_singles": (CS.make_pair_of_singles(pool=True, gram=True), (8, 8, 64),
                             [(64, 64), (64, 64)], False),
    "make_wide_single": (CS.make_wide_single(pool=True, gram=True, slices=2), (8, 24, 64),
                         [(64, 64)], False),
    "make_wide_pair_of_singles": (CS.make_wide_pair_of_singles(pool=False, gram=True, slices=2),
                                  (8, 24, 64), [(64, 64), (64, 64)], False),
    "make_sharded_block1": (B1.make_sharded_block1(MESH), (32, 8, 3), [(3, 64), (64, 64)], True),
    "make_sharded_pair": (CP.make_sharded_pair(MESH, pool=True, gram=True), (32, 8, 64),
                          [(64, 64), (64, 64)], True),
    "make_sharded_single": (CS.make_sharded_single(MESH, pool=True, gram=True), (32, 8, 64),
                            [(64, 64)], True),
    "make_sharded_gram_tail": (CS.make_sharded_gram_tail(MESH), (32, 8, 64), [(64, 64)], True),
    "make_sharded_conv_gram": (CG.make_sharded_conv_gram(MESH), (32, 8, 64), [(64, 64)], True),
    "make_sharded_pair_of_singles": (CS.make_pair_of_singles(pool=False, gram=True, mesh=MESH),
                                     (32, 8, 64), [(64, 64), (64, 64)], True),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_weight_gradients_are_none_on_the_cpu(name):
    fn, (h, w, c), widths, sharded = WRAPPERS[name]
    r = np.random.RandomState(3)
    weights = [torch.from_numpy(a).requires_grad_(True)
               for cin, cout in widths for a in _w(r, cin, cout)]
    x = torch.from_numpy(r.rand(1, h, w, c).astype(np.float32)).requires_grad_(True)
    xin = M.scatter_rows(x, M.row_bounds(h, MESH.size), MESH) if sharded else x
    grads = torch.autograd.grad(_loss(fn(xin, *weights)), [x, *weights], allow_unused=True)
    assert all(g is None for g in grads[1:]), [g is None for g in grads[1:]]
    # the input gradient is not a dead graph: the Nones are the contract
    assert float(grads[0].abs().max()) > 0.0


# the cases of tests/test_weight_grads.py, and the opt-in block-1 kernels:
# (port wrapper, JAX kernel, input C, conv widths)
JAX_CASES = {
    "block1_packed": (B1.block1_packed, JB1P.block1_packed, 3, [(3, 64), (64, 64)]),
    "block1_full": (B1.block1_full, JB1.block1_full, 3, [(3, 64), (64, 64)]),
    "block1_tail": (B1.block1_tail, JB1.block1_tail, 64, [(64, 64)]),
    "pair_gram": (CP.pair_gram, JCP.pair_gram, 64, [(64, 64), (64, 64)]),
    "conv_gram": (CG.conv_gram, JCG.conv_gram, 64, [(64, 64)]),
    "single_gram": (CS.single_gram, JCS.single_gram, 64, [(64, 64)]),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_input_gradient_matches_the_jax_kernel(name):
    fn, jfn, c, widths = JAX_CASES[name]
    r = np.random.RandomState(3)
    weights = [a for cin, cout in widths for a in _w(r, cin, cout)]
    x = r.rand(1, 8, 8, c).astype(np.float32)
    want = jax.grad(lambda x: _loss(jfn(x, *map(jnp.asarray, weights)), jnp.sum))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in weights]
    got, *dw = torch.autograd.grad(_loss(fn(xt, *wt)), [xt, *wt], allow_unused=True)
    assert all(g is None for g in dw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_plain_vgg_path_keeps_true_weight_gradients():
    """``extract_features`` is not a kernel wrapper: its weights get their
    gradients, as under JAX's ``extract_features``."""
    r = np.random.RandomState(0)
    params = {name: dict(zip(("kernel", "bias"), map(torch.from_numpy, _w(r, cin, 64))))
              for name, cin in (("conv1_1", 3), ("conv1_2", 64))}
    k = params["conv1_1"]["kernel"].requires_grad_(True)
    feats = vgg.extract_features(params, torch.rand(1, 8, 8, 3), ["conv1_2"])
    (dk,) = torch.autograd.grad(feats["conv1_2"].sum(), k)
    assert float(dk.abs().max()) > 0.0


@pytest.mark.parametrize("obj", [CP.conv_pair, CP.make_conv_pair, CS.make_conv_single,
                                 CG.conv_gram, B1.block1_packed, B1.block1_full,
                                 B1.block1_tail])
def test_contract_documented(obj):
    doc = obj.__doc__ or ""
    assert "w.r.t." in doc and "frozen" in doc and "``None``" in doc
