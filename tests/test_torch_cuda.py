"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; it
skips elsewhere. The file imports neither JAX nor the JAX package, so on a
GPU machine without JAX it runs on its own (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are small shapes drawn from numpy, with the channel counts of the
VGG layers (Grams need multiples of 64), and spatial sizes off the kernels'
8x16 tile so the ragged tile edges run. The kernel runs in bf16 (TV in fp32) against
its plain version run in fp32 on the same bf16-valued inputs, under the
limits of ``ops/kernels/tolerances.py`` that ``chip_smoke.py`` applies too:
an absolute limit per output, and no less accurate than the plain version
run in bf16.
"""

import numpy as np
import pytest
import torch

from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.ops.kernels import tolerances as T


def _conv_weights(rng, cin, cout):
    k = (rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    return k, b


def _pair_plain(pool, gram):
    return lambda *a: CP.conv_pair_plain(*a, pool=pool, gram=gram)


def _single_plain(pool, gram, gram_cols=None):
    return lambda *a: CS.conv_single_plain(*a, pool=pool, gram=gram, gram_cols=gram_cols)


# single-conv cases at H=10, W=18 (ragged against the 8x16 tile): name ->
# (kernel wrapper, plain version, cin, cout, pool, gram)
SINGLES = {
    "single_plain": (CS.single_plain, _single_plain(False, False), 64, 64, False, False),
    "single_gram": (CS.single_gram, _single_plain(False, True), 64, 128, False, True),
    "single_pool": (CS.single_pool, _single_plain(True, False), 64, 64, True, False),
    "single_pool_gram": (CS.make_conv_single(pool=True, gram=True), _single_plain(True, True),
                         64, 128, True, True),
    "gram_window": (CS.make_conv_single(pool=False, gram=True, gram_cols=(3, 11)),
                    _single_plain(False, True, (3, 11)), 64, 64, False, True),
    "wide_single_slices2": (CS.make_wide_single(pool=True, gram=True, slices=2),
                            _single_plain(True, True), 64, 64, True, True),
    "gram_tail": (CS.gram_tail, lambda *a: CS.conv_single_plain(*a, pool=False, gram=True)[1],
                  128, 128, None, True),
}


def _case(name):
    """(kernel wrapper, plain version, x, weights, cotangent shapes); the
    cotangent of a 2-D shape is a Gram's."""
    rng = np.random.RandomState(0)
    if name in SINGLES:
        kernel, plain, cin, cout, pool, gram = SINGLES[name]
        x = rng.rand(1, 10, 18, cin).astype(np.float32)
        cts = [] if pool is None else [(1, 5, 9, cout) if pool else (1, 10, 18, cout)]
        return kernel, plain, x, _conv_weights(rng, cin, cout), cts + [(cout, cout)] * gram
    if name == "pair_gram":
        x = rng.rand(1, 32, 32, 64).astype(np.float32)
        w = _conv_weights(rng, 64, 64) + _conv_weights(rng, 64, 64)
        return CP.pair_gram, _pair_plain(False, True), x, w, [(1, 32, 32, 64), (64, 64)]
    if name == "pair_pool":
        x = rng.rand(1, 32, 24, 64).astype(np.float32)
        w = _conv_weights(rng, 64, 64) + _conv_weights(rng, 64, 64)
        return CP.pair_pool, _pair_plain(True, False), x, w, [(1, 16, 12, 64)]
    if name == "block2_fused":
        x = rng.rand(1, 32, 24, 64).astype(np.float32)
        w = _conv_weights(rng, 64, 128) + _conv_weights(rng, 128, 128)
        return B2.block2_fused, _pair_plain(True, True), x, w, [(1, 16, 12, 128), (128, 128)]
    if name == "conv_gram":
        x = rng.rand(1, 12, 20, 128).astype(np.float32)
        w = _conv_weights(rng, 128, 128)
        return CG.conv_gram, CG.conv_gram_plain, x, w, [(128, 128)]
    if name == "block1_packed":
        x = rng.randn(1, 32, 40, 3).astype(np.float32)
        w = _conv_weights(rng, 3, 64) + _conv_weights(rng, 64, 64)
        return B1.block1_packed, B1.block1_plain, x, w, [(1, 16, 20, 64), (64, 64)]
    if name == "tv_loss":
        x = rng.rand(1, 20, 18, 3).astype(np.float32)
        return EP.tv_loss, EP.tv_loss_plain, x, (), [()]
    raise KeyError(name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    ["pair_gram", "pair_pool", "block2_fused", "conv_gram", "block1_packed", "tv_loss", *SINGLES],
)
def test_cuda_kernel_matches_plain_version(name, cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, plain, x, w, ct_shapes = _case(name)
    dtype = torch.float32 if name == "tv_loss" else torch.bfloat16
    bf = lambda a: torch.from_numpy(a).to(cuda_device).to(dtype).float()  # noqa: E731
    xs, ws = bf(x), [bf(a) for a in w]
    rng = np.random.RandomState(100)
    cts = [bf(np.asarray(rng.randn(*s), np.float32)) for s in ct_shapes]

    def run(fn, dt):
        xr = xs.to(dt).requires_grad_(True)
        outs = fn(xr, *ws)
        outs = outs if isinstance(outs, tuple) else (outs,)
        (dx,) = torch.autograd.grad(outs, xr, grad_outputs=[c.to(o.dtype) for c, o in zip(cts, outs)])
        return [o.detach().float() for o in outs] + [dx.float()]

    k_res, p_res, r_res = run(kernel, dtype), run(plain, dtype), run(plain, torch.float32)
    torch.cuda.synchronize()
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))  # noqa: E731
    if name == "tv_loss":
        tols = [T.TOL_TV, T.TOL_TV]
    else:
        tols = [T.TOL_GRAM if len(s) == 2 else T.TOL_ACT for s in ct_shapes] + [T.TOL_DX]
    for i, (k, p, r, tol) in enumerate(zip(k_res, p_res, r_res, tols)):
        assert T.within(rel(k, r), rel(p, r), tol), (i, rel(k, r), rel(p, r), tol)


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels(cuda_device):
    """A CUDA tensor goes through the kernel (the launch count grows), never
    through the plain version."""
    kernel, _, x, w, _ = _case("block2_fused")
    before = CP.launches.n
    out, gram = kernel(torch.from_numpy(x).to(cuda_device, torch.bfloat16),
                       *[torch.from_numpy(a).to(cuda_device) for a in w])
    assert CP.launches.n == before + 3  # conv a, conv b (+ pool + mask), Gram
    assert out.dtype == torch.bfloat16 and gram.dtype == torch.float32


@pytest.mark.cuda
def test_cuda_single_counts_its_launches(cuda_device):
    """The single and gram_tail launch on the card, each under its own
    counter: conv and Gram forward, Gram term and transposed conv backward."""
    x = torch.rand(1, 10, 18, 64, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    k, b = (torch.from_numpy(a).to(cuda_device) for a in _conv_weights(np.random.RandomState(0), 64, 64))
    before, tail_before = CS.launches.n, CS.gram_tail_launches.n
    out, gram = CS.single_gram(x, k, b)
    assert CS.launches.n == before + 2
    torch.autograd.grad((out.float().sum() + gram.sum()), x)
    assert CS.launches.n == before + 4
    (dx,) = torch.autograd.grad(CS.gram_tail(x, k, b).sum(), x)
    assert CS.gram_tail_launches.n == tail_before + 4 and CS.launches.n == before + 4
    assert dx.dtype == torch.bfloat16 and torch.isfinite(dx.float()).all()


@pytest.mark.cuda
def test_cuda_kernels_refuse_fp32_activations(cuda_device):
    kernel, _, x, w, _ = _case("pair_pool")
    with pytest.raises(ValueError, match="bf16"):
        kernel(torch.from_numpy(x).to(cuda_device), *[torch.from_numpy(a).to(cuda_device) for a in w])


@pytest.mark.cuda
def test_cuda_fp32_compute_refuses_the_chain(cuda_device):
    """The kernels take bf16 only: an fp32 StyleTransfer on the card raises
    for the fused chain instead of running the plain path, and runs the plain
    path (no kernel launch) only when asked with ``use_fused=False``."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig

    rng = np.random.RandomState(0)
    content = rng.rand(64, 64, 3).astype(np.float32)
    style = rng.rand(64, 64, 3).astype(np.float32)
    st = StyleTransfer(device=cuda_device, compute_dtype=torch.float32)
    cfg = dict(size=64, min_scale=64, iterations=(1,))
    with pytest.raises(ValueError, match="bf16"):
        st.stylize(content, style, StylizeConfig(**cfg))
    counters = [B1.launches, CP.launches, CG.launches, EP.launches]
    before = [c.n for c in counters]
    out = st.stylize(content, style, StylizeConfig(use_fused=False, **cfg))
    assert [c.n for c in counters] == before
    assert out.shape == (64, 64, 3) and np.isfinite(out).all()
