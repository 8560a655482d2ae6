"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; it
skips elsewhere. The file imports neither JAX nor the JAX package, so on a
GPU machine without JAX it runs on its own (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are small shapes drawn from numpy, with the channel counts of the
VGG layers (Grams need multiples of 64), and spatial sizes off the kernels'
tiles (8x8, 8x16 and 16x16 pixels) so the ragged tile edges run (the
``_narrow`` block-1 cases are 26x12: narrower than one tile, and a ragged
last tile row); ``ops/kernels/selfcheck.py`` adds the launchers of the
tensor-core conv and Gram kernels one option at a time, the one-pass
block-1 kernels at ragged sizes with each cotangent alone, and the fused
losses from one element to 12.6 M. The kernel runs in bf16 (TV in fp32) against
its plain version run in fp32 on the same bf16-valued inputs, under the
limits of ``ops/kernels/tolerances.py`` that ``chip_smoke.py`` applies too:
an absolute limit per output, and no less accurate than the plain version
run in bf16.
"""

import contextlib

import numpy as np
import pytest
import torch

from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import block2 as B2
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.ops.kernels import gram as KG
from style_transfer_tpu_torch.ops.kernels import selfcheck
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
    if name in ("block1_full", "block1_full_narrow"):
        h, wd = (32, 40) if name == "block1_full" else (26, 12)
        x = rng.randn(1, h, wd, 3).astype(np.float32)
        w = _conv_weights(rng, 3, 64) + _conv_weights(rng, 64, 64)
        return B1.block1_full, B1.block1_plain, x, w, [(1, h // 2, wd // 2, 64), (64, 64)]
    if name in ("block1_tail", "block1_tail_narrow"):
        h, wd = (32, 40) if name == "block1_tail" else (26, 12)
        x = np.maximum(rng.randn(1, h, wd, 64), 0).astype(np.float32)
        return (B1.block1_tail, B1.block1_tail_plain, x, _conv_weights(rng, 64, 64),
                [(1, h // 2, wd // 2, 64), (64, 64)])
    if name == "pallas_gram":  # N = 2, M = 2*10*18 rows: a ragged last row chunk
        x = rng.randn(2, 10, 18, 128).astype(np.float32)
        return KG.pallas_gram, KG.gram_plain, x, (), [(128, 128)]
    if name in ("content_loss", "content_loss_fp32"):  # 1*5*7*24 = 840 elements
        x = rng.rand(1, 5, 7, 24).astype(np.float32)
        return EP.content_loss, EP.content_loss_plain, x, (rng.rand(1, 5, 7, 24).astype(np.float32),), [()]
    if name == "content_loss_large":  # more than one block, plus a ragged tail
        x = rng.rand(1, 33, 47, 65).astype(np.float32)
        return EP.content_loss, EP.content_loss_plain, x, (rng.rand(1, 33, 47, 65).astype(np.float32),), [()]
    if name in ("style_loss_64", "style_loss_512"):
        c = int(name.rsplit("_", 1)[1])
        x = rng.randn(c, c).astype(np.float32)
        return EP.style_loss, EP.style_loss_plain, x, (rng.randn(c, c).astype(np.float32),), [()]
    raise KeyError(name)


# cases whose kernel runs in fp32, and per-output limits where the rule below
# (Gram for a 2-D cotangent, activation otherwise, then the input gradient)
# does not apply
FP32_CASES = {"tv_loss", "content_loss_fp32", "style_loss_64", "style_loss_512"}
LOSS_TOLS = {
    "tv_loss": [T.TOL_TV, T.TOL_TV],
    "content_loss": [T.TOL_LOSS, T.TOL_ACT],
    "content_loss_large": [T.TOL_LOSS, T.TOL_ACT],
    "content_loss_fp32": [T.TOL_LOSS, T.TOL_LOSS],
    "style_loss_64": [T.TOL_LOSS, T.TOL_LOSS],
    "style_loss_512": [T.TOL_LOSS, T.TOL_LOSS],
}
NEW_CASES = ["block1_full", "block1_full_narrow", "block1_tail", "block1_tail_narrow",
             "pallas_gram", "content_loss", "content_loss_large", "content_loss_fp32",
             "style_loss_64", "style_loss_512"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    ["pair_gram", "pair_pool", "block2_fused", "conv_gram", "block1_packed", "tv_loss", *SINGLES,
     *NEW_CASES],
)
def test_cuda_kernel_matches_plain_version(name, cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, plain, x, w, ct_shapes = _case(name)
    dtype = torch.float32 if name in FP32_CASES else torch.bfloat16
    bf = lambda a: torch.from_numpy(a).to(cuda_device).to(dtype).float()  # noqa: E731
    xs, ws = bf(x), [bf(a) for a in w]
    rng = np.random.RandomState(100)
    cts = [bf(np.asarray(rng.randn(*s), np.float32)) for s in ct_shapes]

    def run(fn, dt):
        xr = xs.to(dt).requires_grad_(True)
        # a loss target comes in the activation's dtype; conv weights stay fp32
        outs = fn(xr, *([a.to(dt) for a in ws] if name in LOSS_TOLS else ws))
        outs = outs if isinstance(outs, tuple) else (outs,)
        (dx,) = torch.autograd.grad(outs, xr, grad_outputs=[c.to(o.dtype) for c, o in zip(cts, outs)])
        return [o.detach().float() for o in outs] + [dx.float()]

    k_res, p_res, r_res = run(kernel, dtype), run(plain, dtype), run(plain, torch.float32)
    torch.cuda.synchronize()
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))  # noqa: E731
    if name in LOSS_TOLS:
        tols = LOSS_TOLS[name]
    else:
        tols = [T.TOL_GRAM if len(s) == 2 else T.TOL_ACT for s in ct_shapes] + [T.TOL_DX]
    for i, (k, p, r, tol) in enumerate(zip(k_res, p_res, r_res, tols)):
        assert T.within(rel(k, r), rel(p, r), tol), (i, rel(k, r), rel(p, r), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", selfcheck.all_cases())
def test_cuda_tensor_core_kernel_edge_case(name, cuda_device):
    """The launchers of the tensor-core conv and Gram kernels, one option at
    a time, at sizes ragged against every tile and at conv1_1's channel
    counts, the one-pass block-1 kernels with each cotangent alone and
    both, and the fused losses with the cotangents 1, 0.7 and 0
    (``ops/kernels/selfcheck.py``): within the limits of
    ``tolerances.py``, the ReLU mask wrong only within bf16 rounding of zero,
    bit-equal from one launch to the next, and a loss's gradient bit-equal
    to its plain backward."""
    res = selfcheck.run_case(name, cuda_device)
    torch.cuda.synchronize()
    for e in res["errors"]:
        assert T.within(e["rel"], e["plain_bf16_rel"], e["tol"]), (name, e)
    assert res.get("mask_slip", 0.0) <= res.get("mask_slip_limit", 0.0), (name, res)
    assert res["run_to_run_equal"], name
    assert res.get("backward_exact", True), name
    assert res["launches"] == 2


@pytest.mark.cuda
def test_cuda_tile_table_is_the_built_librarys(cuda_device):
    """The wrapper's tile table and shared-memory sizes are those compiled
    into ``csrc/conv3x3.cu``."""
    from style_transfer_tpu_torch.ops.kernels import _build

    assert selfcheck.tile_table_matches(_build.library())


@pytest.mark.cuda
def test_cuda_every_wide_conv_of_a_2048_step_takes_the_wgmma_tile(cuda_device):
    """A 2048^2 Adam chunk of two steps, recorded from its dispatch's start
    to its end (``trace.listen``): every conv launch with more than 64
    output channels, forward and backward-data, took the warpgroup tile
    (the last field of its counted shape), the others an ``mma.sync`` tile,
    and the step launched the same convs as the chain's 26 a step."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig, trace
    from style_transfer_tpu_torch.ops.kernels import _launch

    rng = np.random.RandomState(0)
    content = rng.rand(2048, 2048, 3).astype(np.float32)
    style = rng.rand(1024, 1024, 3).astype(np.float32)
    st = StyleTransfer(device=cuda_device)
    steps, stack = 2, contextlib.ExitStack()

    def listener(phase, name, attrs):
        if name == "dispatch":
            if phase == "start":
                trace.clear()
                stack.enter_context(trace.recording())
            else:
                stack.close()

    handle = trace.listen(listener)
    try:
        st.stylize(content, style, StylizeConfig(size=2048, min_scale=2048, iterations=(steps,),
                                                 chunk_size=steps))
    finally:
        handle.remove()
    convs = {shape: n for (_, kernel, shape), n in trace.counts().items()
             if kernel in ("conv3x3_fwd", "conv3x3_bwd_data")}
    wide = {shape: n for shape, n in convs.items() if shape[3] > 64}
    assert sum(convs.values()) == 26 * steps and sum(wide.values()) % steps == 0
    assert all(shape[-1] == _launch.CONV_WGMMA_TILE for shape in wide), sorted(wide)
    assert all(shape[-1] != _launch.CONV_WGMMA_TILE for shape in convs if shape not in wide)
    assert {shape[0] for shape in wide} == {1024, 512, 256, 128}


@pytest.mark.cuda
def test_cuda_block1_model_is_the_built_librarys(cuda_device):
    """The wrapper's tile, grid, Gram-partial count and shared-memory model
    of the one-pass block-1 kernels are those compiled into
    ``csrc/block1.cu``."""
    from style_transfer_tpu_torch.ops.kernels import _build

    assert selfcheck.block1_model_matches(_build.library())


@pytest.mark.cuda
def test_cuda_loss_grid_model_is_the_built_librarys(cuda_device):
    """The wrapper's threads per block, loads in flight and rows per block of
    the loss kernels are those compiled into ``csrc/epilogue.cu`` and
    ``csrc/tv.cu``."""
    from style_transfer_tpu_torch.ops.kernels import _build

    assert selfcheck.loss_model_matches(_build.library())


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
def test_cuda_block1_kernels_launch_once_forward_and_once_backward(cuda_device):
    """block1_full and block1_tail: one kernel launch forward, one backward
    (the Gram's reduce pass aside), each under its own counter, and nothing
    on the generic pair's."""
    rng = np.random.RandomState(0)
    dev = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    w = [dev(a) for a in _conv_weights(rng, 3, 64) + _conv_weights(rng, 64, 64)]
    x = torch.randn(1, 32, 40, 3, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    r1 = torch.rand(1, 32, 40, 64, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    before = (B1.full_launches.n, B1.tail_launches.n, B1.launches.n, CP.launches.n)
    pool, gram = B1.block1_full(x, *w)
    assert B1.full_launches.n == before[0] + 1
    (dx,) = torch.autograd.grad(pool.float().sum() + gram.sum(), x)
    assert B1.full_launches.n == before[0] + 2
    pool_t, gram_t = B1.block1_tail(r1, *w[2:])
    assert B1.tail_launches.n == before[1] + 1
    (dr1,) = torch.autograd.grad(pool_t.float().sum() + gram_t.sum(), r1)
    assert B1.tail_launches.n == before[1] + 2
    assert (B1.launches.n, CP.launches.n) == before[2:]
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16 and torch.isfinite(dx.float()).all()
    assert dr1.shape == r1.shape and dr1.dtype == torch.bfloat16
    # only the pooled cotangent, and only the Gram's: the missing one reads as zero
    (dx_p,) = torch.autograd.grad(B1.block1_full(x, *w)[0].float().sum(), x)
    (dx_g,) = torch.autograd.grad(B1.block1_full(x, *w)[1].sum(), x)
    torch.testing.assert_close((dx_p.float() + dx_g.float()), dx.float(), rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_cuda_losses_are_deterministic_and_counted(cuda_device):
    """The fused losses sum per-block partials in a fixed order: the same
    bits run to run. Each launch counts under its own counter: one forward,
    one backward. The cotangent is read on the device."""
    f = torch.rand(1, 64, 64, 512, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    t = torch.rand(1, 64, 64, 512, device=cuda_device).to(torch.bfloat16)
    before = (EP.content_launches.n, EP.style_launches.n, KG.launches.n)
    a, b = EP.content_loss(f, t), EP.content_loss(f, t)
    assert a.item() == b.item() and EP.content_launches.n == before[0] + 2
    (df,) = torch.autograd.grad(a, f, retain_graph=True)
    assert df.dtype == torch.bfloat16 and EP.content_launches.n == before[0] + 3
    assert torch.equal(df, EP.sse_backward_plain(torch.ones((), device=cuda_device), f.detach(), t))
    (df7,) = torch.autograd.grad(0.7 * a, f)  # a cotangent that autograd computed on the device
    assert EP.content_launches.n == before[0] + 4
    assert torch.equal(df7, EP.sse_backward_plain(torch.tensor(0.7, device=cuda_device), f.detach(), t))
    g = KG.pallas_gram(f)
    assert KG.launches.n == before[2] + 1 and g.shape == (512, 512)
    s = EP.style_loss(g, g.T.contiguous() * 0.5)
    assert EP.style_launches.n == before[1] + 1 and torch.isfinite(s)
    with pytest.raises(ValueError, match="bf16"):
        KG.pallas_gram(f.detach().float())
    with pytest.raises(ValueError):
        EP.content_loss(f, t.float())


@pytest.mark.cuda
def test_cuda_gram_matrix_dispatch_on_the_card(cuda_device, monkeypatch):
    """``gram_matrix`` launches the kernel for a width of its set from
    ``KERNEL_MIN_ELEMENTS`` elements on and computes the plain Gram below
    (here 32*32*128 = 131072 elements) and for a width outside the set."""
    f = torch.rand(1, 32, 32, 128, device=cuda_device).to(torch.bfloat16)
    wide = torch.rand(1, 8, 8, 512, device=cuda_device).to(torch.bfloat16)
    monkeypatch.setattr(KG, "KERNEL_CHANNELS", frozenset({64, 128, 256}))
    monkeypatch.setattr(KG, "KERNEL_MIN_ELEMENTS", f.numel() + 1)
    before = KG.launches.n
    small = KG.gram_matrix(f)
    KG.gram_matrix(wide)
    assert KG.launches.n == before
    monkeypatch.setattr(KG, "KERNEL_MIN_ELEMENTS", f.numel())
    sent = KG.gram_matrix(f)
    KG.gram_matrix(wide)
    assert KG.launches.n == before + 1
    torch.testing.assert_close(sent, small, rtol=T.TOL_GRAM, atol=1e-6)


@pytest.mark.cuda
def test_cuda_fused_block1_path_launch_counts(cuda_device):
    """``stylize(fused_block1=True)`` on the card: block1_full carries block
    1 (forward + backward per step, forward per capture), TV runs, and none
    of the chain's kernels launch."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig

    rng = np.random.RandomState(0)
    content = rng.rand(64, 64, 3).astype(np.float32)
    style = rng.rand(64, 64, 3).astype(np.float32)
    st = StyleTransfer(device=cuda_device)
    chain = [B1.launches, CP.launches, CG.launches, CS.launches, CS.gram_tail_launches,
             B1.tail_launches]
    before = [c.n for c in chain]
    full, tv = B1.full_launches.n, EP.launches.n
    steps = 3
    out = st.stylize(content, style,
                     StylizeConfig(size=64, min_scale=64, iterations=(steps,), fused_block1=True))
    assert B1.full_launches.n == full + 2 * steps + 2
    assert EP.launches.n == tv + 2 * steps  # forward and backward
    assert [c.n for c in chain] == before
    assert out.shape == (64, 64, 3) and np.isfinite(out).all()


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


@pytest.mark.cuda
def test_cuda_pipelined_chunks_match_sequential(cuda_device):
    """On the card a queued chunk's record holds a ``torch.cuda.Event`` and a
    pinned loss buffer, and queueing a chunk makes no synchronizing call;
    pipelined and sequential runs give the same image, losses and
    ``get_image()``, and an image fetched after later chunks ran is still its
    chunk's."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig, api

    rng = np.random.RandomState(0)
    content = rng.rand(128, 128, 3).astype(np.float32)
    style = rng.rand(128, 128, 3).astype(np.float32)
    st = StyleTransfer(device=cuda_device)
    cfg = dict(size=128, min_scale=64, iterations=(12,), chunk_size=3)
    real, records = st._dispatch_chunk, []

    def dispatch(*args, **kw):  # no callback runs meanwhile: the mode is global
        torch.cuda.set_sync_debug_mode("error")
        try:
            records.append(real(*args, **kw))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return records[-1]

    st._dispatch_chunk = dispatch
    st.stylize(content, style, StylizeConfig(pipeline_chunks=True, **cfg))
    del st._dispatch_chunk
    assert len(records) == 8
    for rec in records:
        assert isinstance(rec.event, torch.cuda.Event) and rec.loss_host.is_pinned()
    runs = {}
    for pipelined in (False, True):
        events, images = [], []
        out = st.stylize(content, style, StylizeConfig(pipeline_chunks=pipelined, **cfg),
                         callback=lambda ev: (events.append(ev), images.append(ev.get_image())))
        runs[pipelined] = (out, events, images)
    (a, ea, ia), (b, eb, ib) = runs[False], runs[True]
    assert np.array_equal(a, b) and len(ea) == len(eb) == 8
    for x, y, u, v in zip(ea, eb, ia, ib):
        assert (x.scale_index, x.iteration, x.done) == (y.scale_index, y.iteration, y.done)
        assert all(np.array_equal(x.losses[k], y.losses[k]) for k in x.losses)
        assert np.array_equal(u, v) and np.array_equal(y.get_image(), v)
    assert api._pipeline_auto(StylizeConfig(), 128 * 128)


@pytest.mark.cuda
def test_cuda_mesh_of_two_shards_matches_unsharded(cuda_device):
    """The objective on a mesh of two shards of the one card
    (``[cuda:0] * 2``) against the unsharded chain: loss terms and image
    gradient within the mesh limits of ``tolerances.py``, and every chain
    kernel launched twice as often."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.parallel import mesh as M

    rng = np.random.RandomState(0)
    content = rng.rand(128, 128, 3).astype(np.float32)
    style = rng.rand(128, 128, 3).astype(np.float32)
    image = np.clip(content + 0.1 * rng.randn(128, 128, 3), 0, 1).astype(np.float32)
    cfg = StylizeConfig(size=128)
    chain = [B1.launches, CP.launches, CG.launches]
    out = []
    for mesh in (None, M.make_mesh(devices=[cuda_device] * 2)):
        st = StyleTransfer(device=cuda_device, mesh=mesh)
        c = st._capture_content(cfg, torch.from_numpy(content)[None].to(cuda_device))
        s = st._capture_style(cfg, torch.from_numpy(style)[None].to(cuda_device))
        before = [k.n for k in chain]
        x = torch.from_numpy(image)[None].to(cuda_device).requires_grad_(True)
        loss, terms = st._build_objective(cfg)(x, c, s)
        (g,) = torch.autograd.grad(loss, x)
        out.append(({k: float(v) for k, v in terms.items()}, g.double().cpu(),
                    [k.n - b for k, b in zip(chain, before)]))
    (t1, g1, n1), (t2, g2, n2) = out
    for k in t1:
        assert abs(t2[k] - t1[k]) <= T.TOL_MESH_TERMS * abs(t1[k])
    assert float((g2 - g1).norm() / g1.norm()) <= T.TOL_MESH_GRAD
    cos = float((g2.flatten() @ g1.flatten()) / (g1.norm() * g2.norm()))
    assert cos >= T.TOL_MESH_COS
    assert all(a > 0 for a in n1) and n2 == [2 * a for a in n1]


# the wrappers whose CUDA Function returns None for the weights: (wrapper,
# input (H, W, C), conv widths)
WEIGHT_WRAPPERS = {
    "block1_packed": (B1.block1_packed, (16, 16, 3), [(3, 64), (64, 64)]),
    "block1_full": (B1.block1_full, (16, 16, 3), [(3, 64), (64, 64)]),
    "block1_tail": (B1.block1_tail, (16, 16, 64), [(64, 64)]),
    "conv_pair": (CP.make_conv_pair(pool=True, gram=True), (16, 16, 64), [(64, 64), (64, 64)]),
    "conv_gram": (CG.conv_gram, (16, 16, 64), [(64, 64)]),
    "single": (CS.make_conv_single(pool=True, gram=True), (16, 16, 64), [(64, 64)]),
    "gram_tail": (CS.gram_tail, (16, 16, 64), [(64, 64)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WEIGHT_WRAPPERS))
def test_cuda_weight_cotangents_are_none(name, cuda_device):
    """Weights with ``requires_grad`` get ``None`` through the CUDA kernels,
    as on the CPU (``tests/test_torch_weight_grads.py``), and the input
    gradient has the bits of a run whose weights take no gradient."""
    fn, (h, w, c), widths = WEIGHT_WRAPPERS[name]
    rng = np.random.RandomState(0)
    weights = [torch.from_numpy(a).to(cuda_device) for cin, cout in widths
               for a in _conv_weights(rng, cin, cout)]
    x = torch.from_numpy(rng.rand(1, h, w, c).astype(np.float32)).to(cuda_device, torch.bfloat16)

    def grads(ws):
        xr = x.clone().requires_grad_(True)
        out = fn(xr, *ws)
        out = out if isinstance(out, tuple) else (out,)
        loss = sum(o.float().square().sum() for o in out)
        wanted = [xr] + [t for t in ws if t.requires_grad]
        return torch.autograd.grad(loss, wanted, allow_unused=True)

    free = grads(weights)[0]
    got, *dw = grads([t.clone().requires_grad_(True) for t in weights])
    assert all(g is None for g in dw)
    assert torch.equal(got, free)


@pytest.mark.cuda
def test_cuda_weight_cache_is_bounded_per_device(cuda_device):
    """CPU preparations never evict the card's (``_weights.MAX_ENTRIES`` per
    device)."""
    from style_transfer_tpu_torch.ops.kernels import _launch, _weights

    _weights.clear()
    card = [torch.full((4,), float(i), device=cuda_device) for i in range(_weights.MAX_ENTRIES)]
    for t in card:
        _launch.taps(t)
    made = _weights.preparations
    for i in range(_weights.MAX_ENTRIES + 10):
        _launch.taps(torch.full((4,), float(i)))
    assert all(_launch.taps(t) is not None for t in card)
    assert _weights.preparations == made + _weights.MAX_ENTRIES + 10
    devices = [key[-1] for key in _weights._cache]
    assert len(devices) - devices.count("cpu") == devices.count("cpu") == _weights.MAX_ENTRIES
    _weights.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("gram", [False, True])
def test_cuda_make_conv_pair_is_conv_pair(pool, gram, cuda_device):
    """``make_conv_pair`` launches the pair's kernels, with the bits of
    ``conv_pair``."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(1, 16, 24, 64).astype(np.float32)).to(cuda_device, torch.bfloat16)
    ws = [torch.from_numpy(a).to(cuda_device) for cin, cout in ((64, 128), (128, 128))
          for a in _conv_weights(rng, cin, cout)]
    before = CP.launches.n
    got = CP.make_conv_pair(pool=pool, gram=gram)(x, *ws)
    assert CP.launches.n > before
    want = CP.conv_pair(x, *ws, pool=pool, gram=gram)
    got, want = (got, want) if gram else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_bench_quick_record(cuda_device, capsys):
    """``python -m style_transfer_tpu_torch.bench --quick`` on the card: the
    last record carries the 512 px rate on the host's clock beside the
    events', the FLOP count, MFU against the H100 peak, the busy share and
    the peak memory, on the ``cuda`` route."""
    import json

    from style_transfer_tpu_torch import bench

    assert bench.main(["--quick"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(rec) == bench.expected_keys(["--quick"])
    assert rec["route"] == "cuda" and rec["errors"] == []
    assert rec["metric"] == "its_per_sec_512px" and rec["value"] == rec["its_per_sec_512"] > 0
    assert rec["model_tflops_per_it_512"] == bench.model_tflops_per_iter(512)
    assert rec["achieved_tflops_512"] == pytest.approx(
        rec["its_per_sec_512"] * rec["model_tflops_per_it_512"])
    assert 0 < rec["mfu_512"] < 100 and 0 < rec["device_busy_512"] <= 1
    assert rec["peak_mib_512"] > 0 and rec["its_per_sec_512_event"] > 0


@pytest.mark.cuda
def test_cuda_sharded_tv_matches_unsharded(cuda_device):
    """``make_sharded_tv_loss`` on three shards of the one card (uneven
    rows) against the unsharded TV kernel: value and gradient within
    ``TOL_TV``, one launch each way per shard."""
    from style_transfer_tpu_torch.parallel import mesh as M

    img = torch.from_numpy(np.random.RandomState(2).rand(1, 135, 96, 3).astype(np.float32))
    img = img.to(cuda_device)
    mesh = M.make_mesh(devices=[cuda_device] * 3)
    shards = [x.requires_grad_(True) for x in M.shard_image(img, mesh)]
    before = EP.launches.n
    value = EP.make_sharded_tv_loss(mesh)(shards)
    grad = torch.cat(torch.autograd.grad(value, shards), 1)
    assert EP.launches.n - before == 6
    x = img.clone().requires_grad_(True)
    ref = EP.tv_loss(x)
    (ref_grad,) = torch.autograd.grad(ref, x)
    assert abs(float(value) - float(ref)) <= T.TOL_TV * abs(float(ref))
    assert float((grad - ref_grad).norm() / ref_grad.norm()) <= T.TOL_TV
