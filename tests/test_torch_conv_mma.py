"""Host-side code of the tensor-core conv and Gram kernels, on the CPU.

The kernels themselves (``csrc/conv3x3.cu``, ``csrc/gram.cu``) run only on
the card (``tests/test_torch_cuda.py``). What decides their operands, tiles
and scratch lives in Python and is tested here without a GPU: the
backward-data weight layout against a numpy reference and its inverse, the
once-per-tensor weight cache, the tile chooser and its shared-memory model
for every conv shape of VGG-19 at scales 256 to 8192 wide (the warpgroup
tile for every wide conv of the 2048^2 chain), the forced-tile edge cases,
and the Gram kernels' configurations, blocks and scratch.
"""

import numpy as np
import pytest
import torch

from style_transfer_tpu_torch.ops.kernels import _launch, _weights

# (cin, cout) of the VGG-19 convs up to conv5_1, with the pools before them
VGG_CONVS = [(0, 3, 64), (0, 64, 64), (1, 64, 128), (1, 128, 128), (2, 128, 256), (2, 256, 256),
             (3, 256, 512), (3, 512, 512), (4, 512, 512)]
SCALES = [(256, 256), (362, 362), (512, 512), (724, 724), (1024, 1024), (2048, 2048),
          (128, 2048), (256, 4096), (512, 8192)]


def _conv_shapes():
    """(h, w, k, n) of every forward and backward-data launch of the chain."""
    out = []
    for h, w in SCALES:
        for pools, cin, cout in VGG_CONVS:
            hh, ww = h >> pools, w >> pools
            out.append((hh, ww, cin, cout))   # forward
            out.append((hh, ww, cout, cin))   # backward-data
    return out


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 128), (5, 7)])
def test_transposed_taps_match_numpy_and_invert(cin, cout):
    rng = np.random.RandomState(cin)
    w = rng.randn(3, 3, cin, cout).astype(np.float32)
    got = _weights.transpose_taps(torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.is_contiguous() and got.shape == (3, 3, cout, cin)
    want = np.empty((3, 3, cout, cin), np.float32)
    for a in range(3):
        for b in range(3):
            want[a, b] = w[2 - a, 2 - b].T
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    back = _weights.transpose_taps(got)
    np.testing.assert_array_equal(back.float().numpy(),
                                  torch.from_numpy(w).to(torch.bfloat16).float().numpy())


def test_transposed_taps_give_the_input_gradient():
    """A SAME correlation with the transposed taps is the conv's VJP to its
    input: the contract ``conv3x3_bwd_data`` relies on."""
    import torch.nn.functional as F

    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(3, 3, 4, 6).astype(np.float32)).to(torch.bfloat16).float()
    x = torch.from_numpy(rng.randn(1, 4, 7, 5).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.randn(1, 6, 7, 5).astype(np.float32))
    (dx,) = torch.autograd.grad(F.conv2d(x, w.permute(3, 2, 0, 1), padding=1), x, dy)
    w_t = _weights.transpose_taps(w).float()
    got = F.conv2d(dy, w_t.permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(got, dx, rtol=1e-5, atol=1e-5)


def test_weight_cache_prepares_once_per_tensor_and_again_after_an_update():
    _weights.clear()
    w = torch.randn(3, 3, 8, 16)
    before = _weights.preparations
    a = _launch.taps_transposed(w)
    b = _launch.taps_transposed(w)
    assert a is b and _weights.preparations == before + 1
    fwd = _launch.taps(w)
    assert _launch.taps(w) is fwd and _weights.preparations == before + 2
    assert fwd.dtype == torch.bfloat16 and fwd.shape == w.shape
    w.mul_(2.0)  # in place: same storage, new version
    c = _launch.taps_transposed(w)
    assert c is not a and _weights.preparations == before + 3
    torch.testing.assert_close(c.float(), 2.0 * a.float())
    # another tensor of the same shape is another entry
    other = torch.randn(3, 3, 8, 16)
    assert _launch.taps_transposed(other) is not c
    # a bf16 contiguous tensor is its own forward operand
    ready = w.to(torch.bfloat16)
    assert _launch.taps(ready) is ready


def test_weight_cache_is_bounded_and_keeps_its_sources_alive():
    _weights.clear()
    made = [_launch.taps(torch.full((4,), float(i))) for i in range(_weights.MAX_ENTRIES + 10)]
    assert len(_weights._cache) == _weights.MAX_ENTRIES
    # every survivor still answers for its own source (no address was reused)
    for (src, out) in _weights._cache.values():
        assert float(out[0]) == float(src[0])
    assert float(made[-1][0]) == _weights.MAX_ENTRIES + 9
    _weights.clear()
    assert not _weights._cache


def test_weight_cache_is_bounded_per_device():
    """Each device keeps its own MAX_ENTRIES: one card's preparations (39 for
    VGG-19 up to conv5_1) are never evicted by another's, however many a
    mesh over distinct devices makes. Two device keys here: the CPU and
    ``meta`` (shapes differ, since a meta tensor has no address)."""
    _weights.clear()
    before = _weights.preparations
    meta = [torch.empty((i + 1,), device="meta") for i in range(_weights.MAX_ENTRIES)]
    for t in meta:
        _launch.taps(t)
    for i in range(_weights.MAX_ENTRIES + 10):
        _launch.taps(torch.full((4,), float(i)))
    devices = [key[-1] for key in _weights._cache]
    assert devices.count("meta") == devices.count("cpu") == _weights.MAX_ENTRIES
    assert _weights.preparations == before + 2 * _weights.MAX_ENTRIES + 10
    first = _launch.taps(meta[0])  # the CPU's evictions left the meta entries alone
    assert _weights.preparations == before + 2 * _weights.MAX_ENTRIES + 10
    assert first.dtype == torch.bfloat16 and first.device.type == "meta"
    _weights.clear()
    assert not _weights._cache


@pytest.mark.parametrize("tile", sorted(_launch.CONV_TILES))
def test_tile_shared_memory_fits_two_blocks_on_an_sm(tile):
    """Each tile fits the blocks per SM it declares (``MINB``) in an SM's
    shared memory: the ``mma.sync`` tiles two or more, the warpgroup tile
    one (its ring of four stages takes 189 KB)."""
    smem = _launch.conv_tile_smem(tile)
    assert 0 < smem <= _launch.MAX_SHARED_BYTES
    th, tw, bn, warps, stages, minb = _launch.CONV_TILES[tile]
    # MINB blocks (and 1 KB the CUDA runtime reserves for each) share an SM's 228 KB
    assert minb * (smem + 1024) <= 228 * 1024
    if tile == _launch.CONV_WGMMA_TILE:
        # two consumer warpgroups of m64n128 tiles and a producer warpgroup
        assert minb == 1 and warps == 12 and bn == 128
        assert th % 8 == 0 and tw % 8 == 0 and (th * tw // 64) % 2 == 0  # 8x8 patches each
        assert stages >= 3  # one stage in flight, one ready, one loading
    else:
        assert minb >= 2
        assert th % 2 == 0 and tw % 8 == 0 and stages >= 2
        assert (th * tw // 16) * max(bn // 8, 1) % warps == 0  # whole MMA tiles per warp


def test_wgmma_tile_shared_memory_is_its_ring():
    """The warpgroup tile's shared memory: four stages of the haloed 18x18
    input at 32 bytes a pixel (rounded up to 1024 bytes) and the nine taps'
    16 x 128 weights, larger than its fp32 256 x 136 output tile, then two
    mbarriers a stage and 1024 bytes to align the swizzle atoms."""
    stage = 11 * 1024 + 9 * 16 * 128 * 2
    assert 18 * 18 * 32 <= 11 * 1024 and stage % 1024 == 0
    assert _launch.conv_tile_smem(_launch.CONV_WGMMA_TILE) == 4 * stage + 4 * 16 + 1024 == 193600
    assert 256 * 136 * 4 < 4 * stage


def _chain_2048():
    """(h, w, k, n) of every forward and backward-data launch of the 2048^2
    chain whose output has more than 64 channels."""
    out = []
    for pools, cin, cout in VGG_CONVS:
        s = 2048 >> pools
        out += [(s, s, cin, cout), (s, s, cout, cin)]
    return [shape for shape in out if shape[3] > 64]


def test_every_wide_conv_of_the_2048_chain_takes_the_wgmma_tile():
    shapes = _chain_2048()
    assert {s[0] for s in shapes} == {1024, 512, 256, 128}
    for h, w, _, n in shapes:
        assert _launch.conv_tile(h, w, n) == _launch.CONV_WGMMA_TILE, (h, w, n)


@pytest.mark.parametrize("h,w,k,n", _conv_shapes())
def test_tile_chooser_covers_every_vgg_shape(h, w, k, n):
    tile = _launch.conv_tile(h, w, n)
    th, tw, bn = _launch.CONV_TILES[tile][:3]
    assert _launch.conv_tile_smem(tile) <= _launch.MAX_SHARED_BYTES
    blocks = _launch.conv_blocks(tile, h, w, n)
    assert blocks >= 1
    assert th * -(-h // th) >= h and tw * -(-w // tw) >= w and bn * -(-n // bn) >= n
    assert -(-h // th) <= 65535 and -(-n // bn) <= 65535  # gridDim.y / .z
    wg_blocks = _launch.conv_blocks(_launch.CONV_WGMMA_TILE, h, w, n)
    if n <= 8:
        assert bn == 8  # conv1_1's backward-data does not pay for 64 columns
    elif n > 64:
        # the warpgroup tile where more than a quarter of the SMs get a block
        want = _launch.CONV_WGMMA_TILE if 4 * wg_blocks > _launch.SM_COUNT else 2
        assert tile == want
    elif 4 * _launch.conv_blocks(1, h, w, n) < 3 * _launch.SM_COUNT:
        assert tile == 2  # the small tile fills the card
    else:
        assert tile == 1
    if tile == _launch.CONV_WGMMA_TILE:
        assert n > 64 and 4 * blocks > _launch.SM_COUNT


@pytest.mark.parametrize("h,w,n", [(16, 16, 512), (32, 32, 512), (64, 64, 256), (8, 512, 128)])
def test_small_grids_keep_the_mma_sync_tiles(h, w, n):
    """Where the warpgroup tile would leave three quarters of the SMs or more
    without a block (the deep layers of the ladder's small scales), the
    small 8x8-pixel tile fills the card."""
    assert 4 * _launch.conv_blocks(_launch.CONV_WGMMA_TILE, h, w, n) <= _launch.SM_COUNT
    assert _launch.conv_tile(h, w, n) == 2


def test_forced_tile_is_checked():
    assert _launch._tile(None, 1024, 1024, 128) == _launch.conv_tile(1024, 1024, 128)
    for tile in _launch.CONV_TILES:
        assert _launch._tile(tile, 10, 6, 64) == tile
    with pytest.raises(ValueError, match="no tile configuration"):
        _launch._tile(len(_launch.CONV_TILES), 10, 6, 64)


def test_selfcheck_forces_every_conv_case_on_every_tile():
    from style_transfer_tpu_torch.ops.kernels import selfcheck

    forced = selfcheck.forced_conv_cases()
    base = selfcheck.conv_fwd_cases() + selfcheck.conv_bwd_cases()
    by_tile = {}
    for name in forced:
        tag, case = name.split(":")
        assert case in base
        by_tile.setdefault(int(tag[len("tile"):]), []).append(case)
    assert set(by_tile) == set(_launch.CONV_TILES)
    for tile, cases in by_tile.items():
        if _launch.CONV_TILES[tile][2] > 8:
            assert cases == base  # every size and mode, ragged edges included
        else:
            assert cases and all(c.endswith("to3") for c in cases)
    assert set(forced) <= set(selfcheck.all_cases())


#: (M, C) of the Grams of one 2048^2 step (VGG-19: conv1_1 .. conv5_1;
#: ResNet-50: conv1, layer1 .. layer4), each with the configuration the
#: choosers give it: the F^T F configuration (``GRAM_CONFIGS``: 64-wide
#: tiles, 128-wide, 128-wide with the rows in chunks where the Gram has 2 to
#: 132 tiles) and the F S tile width, and the F^T F kernel's blocks
GRAM_STEP_SHAPES = [
    ((2048 * 2048, 64), (0, 64, 132)), ((1024 * 1024, 128), (1, 64, 132)),
    ((512 * 512, 256), (2, 128, 132)), ((256 * 256, 512), (2, 128, 130)),
    ((128 * 128, 512), (2, 128, 130)), ((1024 * 1024, 64), (0, 64, 132)),
    ((512 * 512, 256), (2, 128, 132)), ((256 * 256, 512), (2, 128, 130)),
    ((128 * 128, 1024), (2, 128, 108)), ((64 * 64, 2048), (1, 128, 132)),
]


def _gram_work(m, c):
    tile = _launch.GRAM_CONFIGS[_launch.gram_config(m, c)][0]
    tiles = _launch.gram_tiles(c, tile)
    return tile, tiles, tiles * -(-m // _launch.GRAM_ROW_STEP)


@pytest.mark.parametrize("c", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("m", [60, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304])
def test_gram_rows_per_chunk_fills_the_card_or_covers_m(m, c):
    """The F^T F kernel's blocks: split evenly, a contiguous run of the
    (tile, 64-row step) pairs each, one an SM unless a block would take
    fewer than GRAM_MIN_STEPS steps, never more blocks than steps; in
    chunks of rows, a block a tile of a chunk, as many chunks of
    GRAM_MIN_STEPS steps or more as the SMs hold. At most one partial tile
    a block, 16 MiB in all."""
    tile, tiles, work = _gram_work(m, c)
    blocks, chunks = _launch.gram_blocks(m, c), _launch.gram_chunks(m, c)
    assert 1 <= blocks <= _launch.SM_COUNT
    if chunks:
        steps = work // tiles
        assert blocks == chunks * tiles and chunks <= steps
        # as many chunks as fill the SMs, unless m leaves fewer steps
        fewer = max(1, steps // _launch.GRAM_MIN_STEPS)
        assert blocks + tiles > _launch.SM_COUNT or chunks == fewer
    else:
        assert blocks <= work
        assert blocks == _launch.SM_COUNT or blocks == max(1, work // _launch.GRAM_MIN_STEPS)
    # scratch stays small beside the activation: a partial tile a block, at
    # most 16 MiB
    assert blocks * tile * tile * 4 <= 16 * 2**20


def test_gram_tiles_count_the_upper_triangle():
    assert [_launch.gram_tiles(c) for c in (64, 128, 256, 512)] == [1, 3, 10, 36]
    assert [_launch.gram_tiles(c, 128) for c in (128, 256, 512, 1024, 2048)] == [1, 3, 10, 36, 136]


@pytest.mark.parametrize("shape,cfg", GRAM_STEP_SHAPES)
def test_gram_step_shapes_take_their_configuration(shape, cfg):
    """Each Gram of a 2048^2 step of either network lands on the intended
    configuration: F^T F on 64-wide tiles at 64 channels (the whole Gram one
    tile, one warpgroup), 128 elsewhere, the rows in chunks from 256 to 1024
    channels; F S 64 wide up to 128 channels, 128 from 256; one F^T F block
    an SM, or the chunks' blocks (130 of 10 tiles, 108 of 36)."""
    m, c = shape
    assert (_launch.gram_config(m, c), _launch.gram_fs_width(m, c),
            _launch.gram_blocks(m, c)) == cfg
    assert _launch._gram_plan(m, c)[:2] == (cfg[0], _launch.GRAM_CONFIGS[cfg[0]][0])


#: (M, C) of the Grams of a VGG-19 ladder's 256, 512 and 1024 px scales
#: (conv1_1 .. conv5_1) and the configurations (F^T F, F S width) that were
#: fastest there on an H100, or within 0.2 us of it (``PERF.md`` §6)
GRAM_LADDER_SHAPES = [
    ((65536, 64), (0, 64)), ((16384, 128), (0, 64)), ((4096, 256), (0, 64)),
    ((1024, 512), (0, 64)), ((256, 512), (0, 64)),
    ((262144, 64), (0, 64)), ((65536, 128), (1, 64)), ((16384, 256), (2, 128)),
    ((4096, 512), (0, 64)), ((1024, 512), (0, 64)),
    ((1048576, 64), (0, 64)), ((262144, 128), (1, 64)), ((65536, 256), (2, 128)),
    ((16384, 512), (2, 128)), ((4096, 512), (0, 64)),
]


@pytest.mark.parametrize("shape,cfg", GRAM_LADDER_SHAPES)
def test_gram_ladder_shapes_take_the_fastest_configuration(shape, cfg):
    """The choosers send the ladder's smaller Grams where the card ran them
    fastest: 64-wide F^T F tiles while F holds at most 2^21 elements, 64-wide
    F S tiles at 128 channels and while the 128-wide ones would not
    outnumber the SMs."""
    m, c = shape
    assert (_launch.gram_config(m, c), _launch.gram_fs_width(m, c)) == cfg


@pytest.mark.parametrize("c", range(64, 2049, 64))
def test_gram_scratch_bound_holds_at_every_width(c):
    for m in (60, 4096, 16384, 262144, 4194304):
        tile = _launch.GRAM_CONFIGS[_launch.gram_config(m, c)][0]
        assert c % tile == 0 and c % _launch.gram_fs_width(m, c) == 0
        assert _launch.gram_blocks(m, c) * tile * tile * 4 <= 16 * 2**20


def _block_of(x, blocks, work):
    # csrc/gram.cu's block_of: the largest b with b * work // blocks <= x
    return ((x + 1) * blocks + work - 1) // work - 1


def _pieces(m, c):
    """csrc/gram.cu's split of F^T F, modelled step by step: for each tile,
    its pieces in the order the reduce pass adds them, as (block, steps,
    where the piece lies: "out" or a slot)."""
    tile, tiles, work = _gram_work(m, c)
    blocks, chunks, steps = _launch.gram_blocks(m, c), _launch.gram_chunks(m, c), work // tiles
    by_tile = {t: [] for t in range(tiles)}
    if chunks:
        assert blocks == chunks * tiles
        for b in range(blocks):  # a block a tile of a chunk; the chunks in order
            z, t = divmod(b, tiles)
            run = list(range(z * steps // chunks, (z + 1) * steps // chunks))
            assert run
            by_tile[t].append((b, run, "out" if z == 0 else b))
        return by_tile
    for b in range(blocks):
        lo, hi = b * work // blocks, (b + 1) * work // blocks
        assert lo < hi
        for t in range(lo // steps, (hi - 1) // steps + 1):
            start, end = max(lo, t * steps), min(hi, (t + 1) * steps)
            # a tile's first piece goes to the output, the block's other (its
            # first, starting inside a tile) to slot b - 1
            where = "out" if start == t * steps else b - 1
            assert where == "out" or start == lo
            by_tile[t].append((b, list(range(start - t * steps, end - t * steps)), where))
    for t, pieces in by_tile.items():  # the reduce's range of blocks
        first = _block_of(t * steps, blocks, work)
        last = _block_of((t + 1) * steps - 1, blocks, work)
        assert [p[0] for p in pieces] == list(range(first, last + 1))
    return by_tile


@pytest.mark.parametrize("m,c", [(60, 64), (5000, 256), (65536, 512), (16384, 1024),
                                 (4096, 2048), (1024, 512), (64, 2048), (4194304, 64),
                                 (262144, 256), (131080, 512), (65536, 512)])
def test_gram_pieces_are_numbered_without_gaps_or_collisions(m, c):
    """Every step of every tile is summed exactly once, its first piece
    into the output and each other piece into a slot of its own below
    gram_blocks (the scratch's partial tiles), in the order the reduce pass finds them (stream-K: the
    blocks from block_of(the tile's first step) to block_of(its last);
    chunked: chunk by chunk, chunk z's in slot z tiles + t)."""
    tile, tiles, work = _gram_work(m, c)
    by_tile, slots = _pieces(m, c), []
    for t in range(tiles):
        pieces = by_tile[t]
        assert pieces[0][2] == "out" and all(p[2] != "out" for p in pieces[1:])
        assert sorted(k for p in pieces for k in p[1]) == list(range(work // tiles))
        slots += [p[2] for p in pieces[1:]]
    assert len(set(slots)) == len(slots) and all(0 <= s < _launch.gram_blocks(m, c) for s in slots)
