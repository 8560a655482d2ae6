"""Host-side code of the tensor-core block-1 kernels, on the CPU.

``csrc/block1.cu`` runs only on the card (``tests/test_torch_cuda.py``).
What decides its operands, grid and scratch lives in Python and is tested
here without a GPU and without JAX: conv1_1's padded tap layout against
numpy and its inverse, the patch layout it implies against a plain
convolution, the col2im's plain version against autograd, the shared-memory
model against the 227 KB a block may use, tiles per block and the Gram
partial count at every scale of the 2048 px ladder and at 512x8192, the
once-per-tensor weight cache under ``block1_full`` / ``block1_tail``, and
the edge-case list that the card runs.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from style_transfer_tpu_torch.ops.kernels import _launch, _weights, selfcheck
from style_transfer_tpu_torch.ops.kernels import block1 as B1

# every scale of the 2048 px ladder (256 -> 2048 by sqrt 2), the panorama's
# scales, and sizes ragged against the 16x16 tile
SIZES = [(256, 256), (362, 362), (512, 512), (724, 724), (1024, 1024), (1448, 1448),
         (2048, 2048), (128, 2048), (256, 4096), (512, 8192), (10, 6), (26, 12), (62, 90),
         (128, 136), (210, 300)]


def _taps(seed=0):
    return np.random.RandomState(seed).randn(3, 3, 3, 64).astype(np.float32)


def test_conv1_taps_layout_matches_numpy_and_inverts():
    k1 = _taps()
    got = _weights.pad_conv1_taps(torch.from_numpy(k1))
    assert got.shape == (32, 64) and got.dtype == torch.bfloat16 and got.is_contiguous()
    want = np.zeros((32, 64), np.float32)
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                want[(dy * 3 + dx) * 3 + ci] = k1[dy, dx, ci]
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    assert not got[27:].any()
    back = got[:27].reshape(3, 3, 3, 64)
    np.testing.assert_array_equal(back.float().numpy(),
                                  torch.from_numpy(k1).to(torch.bfloat16).float().numpy())


def _patches(x):
    """(H, W, 3) -> (H, W, 32): the kernel's patch row of a pixel, for each
    dy the nine consecutive (dx, ci) elements of image row h + dy - 1 from
    column w - 1 on, zero outside the image and in columns 27..31."""
    h, w, _ = x.shape
    xp = np.zeros((h + 2, (w + 2) * 3), np.float32)
    xp[1:-1, 3:-3] = x.reshape(h, w * 3)
    out = np.zeros((h, w, 32), np.float32)
    for dy in range(3):
        for c in range(w):
            out[:, c, 9 * dy:9 * dy + 9] = xp[dy:dy + h, 3 * c:3 * c + 9]
    return out


def test_patch_layout_times_padded_taps_is_conv1_1():
    """The kernel's forward contraction (patch rows x the (32, 64) taps as
    [k][n]) is the SAME 3x3 convolution; its backward's 27-wide product (the
    same bytes as [n][k]) followed by the col2im is the conv's VJP."""
    rng = np.random.RandomState(1)
    x = rng.randn(6, 10, 3).astype(np.float32)
    k1 = torch.from_numpy(_taps(1)).to(torch.bfloat16).float()
    taps = _weights.pad_conv1_taps(k1).float().numpy()
    got = _patches(x) @ taps
    xt = torch.from_numpy(x).permute(2, 0, 1)[None].requires_grad_(True)
    ref = F.conv2d(xt, k1.permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got, ref[0].permute(1, 2, 0).detach().numpy(), rtol=1e-5, atol=1e-5)
    dpre = rng.randn(6, 10, 64).astype(np.float32)
    dpt = (dpre @ taps.T)[..., :27].reshape(6, 10, 9, 3).transpose(2, 0, 1, 3)
    dx = B1._col2im3(torch.from_numpy(np.ascontiguousarray(dpt)))
    (want,) = torch.autograd.grad(ref, xt, torch.from_numpy(dpre).permute(2, 0, 1)[None])
    np.testing.assert_allclose(dx.numpy(), want[0].permute(1, 2, 0).numpy(), rtol=1e-4, atol=1e-5)


def test_col2im_plain_sums_in_fp32_in_tap_order():
    rng = np.random.RandomState(2)
    dpt = torch.from_numpy(rng.randn(9, 5, 7, 3).astype(np.float32)).to(torch.bfloat16)
    got = B1._col2im3(dpt)
    assert got.dtype == torch.float32 and got.shape == (5, 7, 3)
    want = np.zeros((5, 7, 3), np.float32)
    d = dpt.float().numpy()
    for h in range(5):
        for w in range(7):
            for tap in range(9):
                hh, ww = h + 1 - tap // 3, w + 1 - tap % 3
                if 0 <= hh < 5 and 0 <= ww < 7:
                    want[h, w] += d[tap, hh, ww]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_block1_shared_memory_fits_one_block_per_sm(full, backward):
    smem = _launch.block1_smem(full, backward)
    # 227 KB a block may use; the SM's 228 KB keep 1 KB for the runtime
    assert 0 < smem <= _launch.MAX_SHARED_BYTES
    assert smem + 1024 <= 228 * 1024
    # the nine resident taps alone are 82,944 bytes: no two blocks share an SM
    assert 2 * smem > _launch.MAX_SHARED_BYTES
    row = _launch.BLOCK1_ROW * 2
    assert row == 144 and smem >= 9 * 64 * row
    # eight neighbouring rows fall into eight different 16-byte bank groups
    assert len({(i * row) % 128 // 16 for i in range(8)}) == 8


def test_block1_shared_memory_values():
    assert _launch.block1_smem(False, False) == 176256
    assert _launch.block1_smem(True, False) == 163904
    assert _launch.block1_smem(False, True) == 222336
    assert _launch.block1_smem(True, True) == 226944


@pytest.mark.parametrize("h,w", SIZES)
def test_block1_tiles_per_block_and_partials(h, w):
    tiles = _launch.block1_tiles(h, w)
    per = _launch.block1_tiles_per_block(h, w)
    blocks = _launch.block1_blocks(h, w)
    th, tw = _launch.BLOCK1_TILE
    assert tiles == -(-h // th) * -(-w // tw) and tiles < 2**31
    assert 1 <= blocks <= _launch.SM_COUNT
    assert (blocks - 1) * per < tiles <= blocks * per  # the last block has a run, maybe short
    assert per == 1 or blocks > _launch.SM_COUNT // 2  # a large image fills most of the card
    # the Gram's scratch: one (64, 64) fp32 partial per block, whatever the image
    assert blocks * 64 * 64 * 4 <= 132 * 16384


def test_block1_known_grids():
    assert (_launch.block1_tiles_per_block(1024, 1024), _launch.block1_blocks(1024, 1024)) == (32, 128)
    assert (_launch.block1_tiles_per_block(512, 8192), _launch.block1_blocks(512, 8192)) == (125, 132)
    assert (_launch.block1_tiles_per_block(10, 6), _launch.block1_blocks(10, 6)) == (1, 1)
    # 266 tiles: 88 blocks of three and a last block of two
    assert (_launch.block1_tiles_per_block(210, 300), _launch.block1_blocks(210, 300)) == (3, 89)


class _Recorder:
    """Stands in for the card's launchers: records the operands."""

    def __init__(self):
        self.calls = []

    def fwd(self, src, k2, b2, *, count, k1=None, b1=None):
        self.calls.append(("fwd", k2, b2, k1, b1))
        h, w, _ = src.shape
        r1 = src if k1 is None else torch.zeros(h, w, 64, dtype=torch.bfloat16)
        return (torch.zeros(h // 2, w // 2, 64, dtype=torch.bfloat16), torch.zeros(64, 64), r1,
                torch.zeros(h, w, 64, dtype=torch.int8))

    def bwd(self, d_pool, mask, r1, s, k2t, *, count, k1=None):
        self.calls.append(("bwd", k2t, k1, s))
        h, w, _ = r1.shape
        return torch.zeros((h, w, 64) if k1 is None else (9, h, w, 3), dtype=torch.bfloat16)


@pytest.mark.parametrize("kind", ["full", "tail"])
def test_block1_weights_are_prepared_once(kind, monkeypatch):
    """``FullFunction`` / ``TailFunction`` take every weight operand from the
    cache: a second forward and backward prepares nothing, and the operands
    are the same tensors in the forms the kernels read."""
    rec = _Recorder()
    monkeypatch.setattr(_launch, "block1_fwd", rec.fwd)
    monkeypatch.setattr(_launch, "block1_bwd", rec.bwd)
    monkeypatch.setattr(_launch, "block1_col2im", lambda dpt: B1._col2im3(dpt).to(torch.bfloat16))
    _weights.clear()
    rng = np.random.RandomState(3)
    k1, b1 = torch.from_numpy(_taps(3)), torch.from_numpy(rng.randn(64).astype(np.float32))
    k2 = torch.from_numpy(rng.randn(3, 3, 64, 64).astype(np.float32))
    b2 = torch.from_numpy(rng.randn(64).astype(np.float32))

    def call():
        if kind == "full":
            x = torch.zeros(1, 8, 12, 3, dtype=torch.bfloat16, requires_grad=True)
            pool, gram = B1.FullFunction.apply(x, k1, b1, k2, b2)
        else:
            x = torch.zeros(1, 8, 12, 64, dtype=torch.bfloat16, requires_grad=True)
            pool, gram = B1.TailFunction.apply(x, k2, b2)
        (dx,) = torch.autograd.grad(pool.float().sum() + gram.sum(), x)
        assert dx.shape == x.shape and dx.dtype == torch.bfloat16

    before = _weights.preparations
    call()
    first = _weights.preparations - before
    assert first == (5 if kind == "full" else 3)  # k2, k2^T, b2 (+ conv1_1's taps, b1)
    call()
    assert _weights.preparations == before + first
    (_, k2a, b2a, k1a, b1a), (_, k2ta, k1ba, s), (_, k2b, b2b, k1b, _), (_, k2tb, _, _) = rec.calls
    assert k2a is k2b and b2a is b2b and k2ta is k2tb and k1a is k1b
    assert k2a.dtype == torch.bfloat16 and k2a.shape == (3, 3, 64, 64)
    assert b2a.dtype == torch.float32 and b2a is b2  # an fp32 bias is its own operand
    assert s.dtype == torch.bfloat16 and s.shape == (64, 64)
    torch.testing.assert_close(k2ta, _weights.transpose_taps(k2))
    if kind == "full":
        assert k1a is k1ba and k1a.shape == (32, 64) and b1a is b1
        torch.testing.assert_close(k1a, _weights.pad_conv1_taps(k1))
    else:
        assert k1a is None and k1ba is None


def test_block1_edge_case_list():
    """The cases the card runs (``selfcheck.block1_cases``): both kernels,
    each cotangent alone and both, at every ragged size, an image smaller
    than one tile and one whose last block has a short run; and the col2im."""
    cases = selfcheck.block1_cases()
    assert len(cases) == len(set(cases)) == 2 * 3 * 5 + 5
    assert set(cases) <= set(selfcheck.all_cases())
    for kind in ("block1full", "block1tail"):
        for ct in ("pool", "gram", "both"):
            for size in ("10x6", "26x12", "62x90", "128x136", "210x300"):
                assert f"{kind}-{ct}-{size}" in cases
    h, w = 10, 6
    assert _launch.block1_tiles(h, w) == 1 and h < 16 and w < 16
    assert 266 % _launch.block1_tiles_per_block(210, 300) != 0
