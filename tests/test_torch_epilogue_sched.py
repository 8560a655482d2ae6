"""The host side of the loss kernels (``csrc/epilogue.cu``, ``csrc/tv.cu``),
on the CPU: what decides their grids, partial counts and the one-block
threshold (``ops/kernels/_launch.py``) at every scale of the 2048 px ladder,
at the 512x8192 panorama and at the edge-case sizes; a model of the kernels'
summation order in torch (per-thread strided sums, warp butterfly, one value
per warp, partials in a fixed order by the last block) against float64 at
12.6 M elements, which is what makes the 1e-5 limit on the losses credible;
the plain backward functions that stand beside the backward kernels against
autograd of the ``ops/losses.py`` oracle; and the cotangent's way to the
kernels. No GPU and no JAX: ``--noconftest`` runs it alone.
"""

import numpy as np
import pytest
import torch

from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.ops.kernels import selfcheck

torch.set_num_threads(2)

# scales of the 2048 px ladder and of the panorama's, as (H, W)
LADDER = [(256, 256), (512, 512), (1024, 1024), (2048, 2048)]
PANORAMA = [(128, 2048), (256, 4096), (512, 8192)]
# (elements, bytes per element): conv4_2 in bf16 and fp32 at every scale, the
# four Gram widths, and the edge-case counts
SSE_SIZES = sorted(
    {((h // 8) * (w // 8) * 512, size) for h, w in LADDER + PANORAMA for size in (2, 4)}
    | {(c * c, 4) for c in (64, 128, 256, 512)}
    | {(n, size) for n in selfcheck.SSE_COUNTS for size in (2, 4)})
TV_SHAPES = LADDER + PANORAMA + list(selfcheck.TV_SIZES)


def _vectors(n, itemsize):
    return n * itemsize // 16


@pytest.mark.parametrize("n, itemsize", SSE_SIZES)
def test_sse_grid_covers_every_vector_once(n, itemsize):
    """The forward's grid: one block up to the threshold (no partials), else
    at most eight blocks per SM; the backward's grid reaches every vector in
    one step. The forward's indexing, replayed for small counts, takes each
    vector exactly once."""
    nvec = _vectors(n, itemsize)
    fwd, bwd = _launch.sse_blocks(n, itemsize), _launch.cast_blocks(n, itemsize)
    assert 1 <= fwd <= _launch.SM_COUNT * _launch.SSE_BLOCKS_PER_SM
    assert (fwd == 1) == (nvec <= _launch.SSE_ONE_BLOCK_VECTORS)
    assert bwd * _launch.SSE_THREADS * _launch.SSE_UNROLL >= nvec and bwd >= 1
    assert fwd <= bwd or fwd == 1
    if nvec <= 1 << 16:
        seen = np.zeros(nvec, np.int64)
        stride = fwd * _launch.SSE_THREADS
        for first in range(0, nvec, stride * _launch.SSE_UNROLL):  # the kernel's loop, all threads
            for u in range(_launch.SSE_UNROLL):
                lo = first + u * stride
                seen[lo:min(lo + stride, nvec)] += 1
        assert (seen == 1).all()


def test_sse_grids_at_the_path_shapes():
    """conv4_2 at 1024 px in bf16 (1 M vectors): four vectors a thread, 1024
    blocks; a 64x64 fp32 Gram: one block; a 512x512 Gram: one vector a thread."""
    assert _launch.sse_blocks(128 * 128 * 512, 2) == 1024
    assert _launch.cast_blocks(128 * 128 * 512, 2) == 1024
    assert _launch.sse_blocks(64 * 64, 4) == 1 and _launch.cast_blocks(64 * 64, 4) == 4
    assert _launch.sse_blocks(512 * 512, 4) == 256 == _launch.cast_blocks(512 * 512, 4)
    assert _launch.sse_blocks(128 * 128 * 512, 4) == _launch.SM_COUNT * _launch.SSE_BLOCKS_PER_SM


@pytest.mark.parametrize("h, w", TV_SHAPES)
@pytest.mark.parametrize("c", [3, 4])
def test_tv_grid_covers_the_image(h, w, c):
    vec, chunks, groups = _launch.tv_grid(h, w * c, c)
    assert vec == (4 if c == 3 and (w * c) % 4 == 0 else 1)
    assert (w * c) % vec == 0
    assert (chunks - 1) * _launch.TV_THREADS * vec < w * c <= chunks * _launch.TV_THREADS * vec
    assert (groups - 1) * _launch.TV_ROWS < h <= groups * _launch.TV_ROWS
    assert groups <= 65535


def test_tv_grid_at_the_path_shapes_and_its_limit():
    assert _launch.tv_grid(512, 512 * 3, 3) == (4, 2, 128)
    assert _launch.tv_grid(512, 8192 * 3, 3) == (4, 24, 128)
    assert _launch.tv_grid(5, 21, 3) == (1, 1, 2)
    with pytest.raises(ValueError, match="rows"):
        _launch.tv_grid(65535 * _launch.TV_ROWS + 1, 12, 3)


# ---- the kernels' summation order, in torch


def _fold(v):
    """A warp's butterfly sum along the last axis: halves folded onto each
    other (lanes i and i ^ 16, then ^ 8, ...)."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _block_sum(v, threads):
    """(..., threads) fp32 -> (...): the warps' butterflies, then one value
    per warp through a butterfly of warp 0 (``st::block_sum``)."""
    return _fold(_fold(v.reshape(*v.shape[:-1], threads // 32, 32)))


def _finish_mean(local, numel, threads):
    """``st::finish_mean``: (blocks, threads) per-thread sums -> the mean."""
    partial = _block_sum(local, threads)
    if partial.numel() > 1:
        pad = -partial.numel() % threads
        steps = torch.cat([partial, torch.zeros(pad)]).reshape(-1, threads)
        acc = torch.zeros(threads)
        for row in steps:  # thread t adds partial[t], partial[t + threads], ...
            acc = acc + row
        partial = _block_sum(acc, threads)
    return partial.reshape(()) / torch.tensor(float(numel), dtype=torch.float32)


def _sequential(terms):
    """Sum along the last axis in order, in fp32."""
    acc = torch.zeros(terms.shape[:-1])
    for s in range(terms.shape[-1]):
        acc = acc + terms[..., s]
    return acc


def sse_model(f, t):
    """``sse_kernel``'s mean for two fp32 or bf16 tensors, in its order."""
    n, itemsize = f.numel(), f.element_size()
    v, threads, unroll = 16 // itemsize, _launch.SSE_THREADS, _launch.SSE_UNROLL
    grid = _launch.sse_blocks(n, itemsize)
    d = f.reshape(-1).to(torch.float32) - t.reshape(-1).to(torch.float32)
    d2 = d * d
    nvec = n // v
    steps = max(1, -(-nvec // (grid * threads * unroll)))
    main = torch.zeros(steps * unroll * grid * threads * v)
    main[:nvec * v] = d2[:nvec * v]
    # vector ((k * unroll + u) * grid + b) * threads + t  ->  [b, t, (k, u, j)]
    main = main.reshape(steps * unroll, grid, threads, v).permute(1, 2, 0, 3)
    local = _sequential(main.reshape(grid, threads, -1))
    local[0, :n - nvec * v] += d2[nvec * v:]  # block 0 takes the last n % v elements
    return _finish_mean(local, n, threads)


def tv_model(x2d, c):
    """``tv_kernel``'s mean for an (H, W*C) fp32 image, in its order."""
    h, wc = x2d.shape
    vec, chunks, groups = _launch.tv_grid(h, wc, c)
    threads, rows = _launch.TV_THREADS, _launch.TV_ROWS
    hp, wp = groups * rows, chunks * threads * vec
    dh2, dw2 = torch.zeros(hp, wp), torch.zeros(hp, wp)
    dh2[:h - 1, :wc] = (x2d[1:] - x2d[:-1]) ** 2
    dw2[:h, :wc - c] = (x2d[:, c:] - x2d[:, :-c]) ** 2
    # a thread adds dh^2 then dw^2 of its columns, left to right, row by row
    terms = torch.stack([dh2, dw2], dim=-1).reshape(groups, rows, chunks, threads, vec, 2)
    terms = terms.permute(0, 2, 3, 1, 4, 5).reshape(groups * chunks, threads, rows * vec * 2)
    return _finish_mean(_sequential(terms), h * wc, threads)


@pytest.mark.parametrize("n, dtype", [(512 * 8192 * 3, torch.float32), (128 * 128 * 512, torch.bfloat16),
                                      (8388611, torch.float32), (64 * 64, torch.float32), (2049, torch.bfloat16)])
def test_sse_summation_order_against_float64(n, dtype):
    gen = torch.Generator().manual_seed(n)
    f = torch.rand(n, generator=gen).to(dtype)
    t = torch.rand(n, generator=gen).to(dtype)
    want = float(((f.double() - t.double()) ** 2).mean())
    got = float(sse_model(f, t))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("h, w", [(512, 8192), (512, 512), (5, 7), (9, 1)])
def test_tv_summation_order_against_float64(h, w):
    x = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(h * w))
    x64 = x.double()
    want = float((((x64[:, 1:] - x64[:, :-1]) ** 2).sum()
                  + ((x64[:, :, 1:] - x64[:, :, :-1]) ** 2).sum()) / x64.numel())
    got = float(tv_model(x.reshape(h, w * 3), 3))
    assert abs(got - want) <= 1e-6 * want
    assert abs(float(L.tv_loss(x)) - want) <= 1e-5 * want


# ---- the plain backward functions against autograd of the oracle


@pytest.mark.parametrize("shape", [(1, 5, 7, 24), (64, 64), (9,)])
@pytest.mark.parametrize("ct", [1.0, 0.7, 0.0])
def test_sse_backward_plain_is_the_oracles_gradient(shape, ct):
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(*shape).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    (want,) = torch.autograd.grad(L.content_loss(a, b), a, grad_outputs=torch.tensor(ct))
    got = EP.sse_backward_plain(torch.tensor(ct), a.detach(), b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-9)
    # a difference that was stored by a forward pass has the same bits
    assert torch.equal(got, EP.scale_cast_plain(a.detach() - b, torch.tensor(ct), a.numel()))


def test_scale_cast_plain_rounds_once_in_bf16():
    """bf16 difference -> fp32, times the fp32 scale (2 ct) / numel formed by
    a true division, -> bf16: the reference's chain."""
    rng = np.random.RandomState(1)
    diff = torch.from_numpy(rng.randn(7, 11).astype(np.float32)).to(torch.bfloat16)
    ct, numel = torch.tensor(0.7), 77
    scale = np.float32(np.float32(2.0) * np.float32(0.7)) / np.float32(numel)
    want = torch.from_numpy(diff.float().numpy() * scale).to(torch.bfloat16)
    got = EP.scale_cast_plain(diff, ct, numel)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    tv = EP.scale_cast_plain(diff.float(), ct, numel, mult=1.0)  # TV's chain: ct / numel
    assert torch.equal(tv, diff.float() * (torch.tensor(0.7) / torch.tensor(77.0)))


@pytest.mark.parametrize("h, w", selfcheck.TV_SIZES[:-1] + ((20, 18),))
@pytest.mark.parametrize("ct", [1.0, 0.7, 0.0])
def test_tv_backward_plain_is_the_oracles_gradient(h, w, ct):
    x = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(h * 100 + w))
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(L.tv_loss(xr), xr, grad_outputs=torch.tensor(ct))
    got = EP.tv_backward_plain(x, torch.tensor(ct))
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-8)


def test_tv_grad_plain_on_a_constant_image_is_zero():
    assert not EP.tv_grad_plain(torch.full((6, 12), 0.3), 3).any()


# ---- the cotangent's way to the kernels


@pytest.mark.parametrize("ct", [torch.tensor(0.7), torch.tensor([0.7]), torch.tensor(0.7, dtype=torch.float64),
                                torch.tensor(0.7).expand(1, 1)])
def test_cotangent_is_one_contiguous_fp32_value(ct):
    out = _launch.cotangent(ct, torch.device("cpu"))
    assert out.dtype == torch.float32 and out.dim() == 0 and out.is_contiguous()
    assert float(out) == pytest.approx(0.7, rel=1e-7)


def test_cotangent_refuses_more_than_one_value():
    with pytest.raises(ValueError, match="scalar"):
        _launch.cotangent(torch.ones(2), torch.device("cpu"))

