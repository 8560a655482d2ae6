"""Typed launchers for the C entry points of the kernel library.

Each launcher checks device, dtype, shape, contiguity and alignment, allocates
every output (and scratch) with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch was refused, and adds one to the caller's
:class:`~style_transfer_tpu_torch.ops.kernels._build.LaunchCount`. Only CUDA
tensors get here; nothing in this module runs on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from style_transfer_tpu_torch.ops.kernels import _weights
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount, library

#: Streaming multiprocessors of the card the tiles are chosen for (H100 SXM).
SM_COUNT = 132
#: Shared memory a block may use on it, in bytes.
MAX_SHARED_BYTES = 232448
#: Reduction channels per chunk of ``csrc/conv3x3.cu`` (its ``KC``).
CONV_KC = 16

#: Tile configurations of ``csrc/conv3x3.cu``: index -> (pixel rows, pixel
#: columns, output channels, warps, pipeline stages). ``chip_smoke.py`` holds
#: the table against the built library (``st_conv3x3_tile_info``).
CONV_TILES = {
    0: (8, 16, 128, 8, 2),
    1: (16, 16, 64, 8, 3),
    2: (8, 8, 64, 4, 2),
    3: (16, 16, 8, 8, 2),
}


def conv_tile_smem(tile: int) -> int:
    """Dynamic shared memory of a block of tile configuration ``tile``, in
    bytes: the larger of its pipeline stages (haloed bf16 input tile at 48
    bytes a pixel plus the 9 x 16 weight rows, padded by 16 bytes where they
    are wider than one ldmatrix row) and the fp32 output tile of the
    epilogue (rows padded by 32 bytes)."""
    th, tw, bn, _, stages = CONV_TILES[tile]
    a_bytes = (th + 2) * (tw + 2) * (CONV_KC + 8) * 2
    b_bytes = 9 * CONV_KC * (bn if bn == 8 else bn + 8) * 2
    return max(stages * (a_bytes + b_bytes), th * tw * (bn + 8) * 4)


def conv_blocks(tile: int, h: int, w: int, n: int) -> int:
    """Blocks of the grid that tile configuration ``tile`` gives an (h, w)
    image with ``n`` output channels."""
    th, tw, bn, _, _ = CONV_TILES[tile]
    return -(-h // th) * -(-w // tw) * -(-n // bn)


def conv_tile(h: int, w: int, n: int) -> int:
    """The tile configuration for an (h, w) image and ``n`` output channels:
    the n8 tile for up to 8 channels (conv1_1's backward-data), else the
    128-channel tile for more than 64 channels and the 16x16-pixel 64-channel
    tile otherwise — unless that leaves more than a quarter of the card's SMs
    without a block, in which case the small 8x8-pixel 64-channel tile fills
    it (the deep layers of small scales). On the H100, 128 blocks of the
    large tile beat 512 of the small one at 128x128 with 128 channels and
    about tie it at 64x64 with 512, while 32 blocks (32x32 with 512) lose
    clearly to 128 small ones (``chip_smoke.py`` prints the rate of every
    conv shape)."""
    if n <= 8:
        return 3
    tile = 0 if n > 64 else 1
    return tile if 4 * conv_blocks(tile, h, w, n) >= 3 * SM_COUNT else 2


#: Rows of F staged per step by ``csrc/gram.cu`` (its ``GR``); a chunk of
#: rows is a multiple of it.
GRAM_ROW_STEP = 64
#: Blocks the Gram's first pass should at least have: two per SM.
GRAM_MIN_BLOCKS = 2 * SM_COUNT


def gram_tiles(c: int) -> int:
    """64x64 tiles of the (c, c) Gram on and above the diagonal."""
    t = c // 64
    return t * (t + 1) // 2


def gram_rows_per_chunk(m: int, c: int) -> int:
    """Rows of the (m, c) activation that one block of the Gram's first pass
    sums: the largest multiple of :data:`GRAM_ROW_STEP` that still gives
    :data:`GRAM_MIN_BLOCKS` blocks (tiles x chunks), and one step where ``m``
    is too small for that."""
    want = -(-GRAM_MIN_BLOCKS // gram_tiles(c))
    return max(GRAM_ROW_STEP, m // want // GRAM_ROW_STEP * GRAM_ROW_STEP)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_launch(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.st_error_string(err).decode()}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def conv3x3_fwd(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, count: LaunchCount,
    y: bool = False, mask: bool = False, pool: bool = False,
):
    """relu(conv3x3_same(x, w) + b) for x (H, W, K) bf16, w (3, 3, K, N) bf16,
    b (N,) bf16. Returns ``(y, mask, pool)``, None where not requested: the
    bf16 ReLU output (H, W, N), its int8 mask ``pre > 0`` (H, W, N), and its
    bf16 2x2 average pool (H/2, W/2, N)."""
    h, wd, k = x.shape
    n = w.shape[3]
    _require(x, "x", torch.bfloat16, (h, wd, k))
    _require(w, "w", torch.bfloat16, (3, 3, k, n))
    _require(b, "b", torch.bfloat16, (n,))
    if n % 4:
        raise ValueError(f"output channels must be a multiple of 4, got {n}")
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"pooling needs even H and W, got {(h, wd)}")
    out_y = torch.empty((h, wd, n), dtype=torch.bfloat16, device=x.device) if y else None
    out_m = torch.empty((h, wd, n), dtype=torch.int8, device=x.device) if mask else None
    out_p = (
        torch.empty((h // 2, wd // 2, n), dtype=torch.bfloat16, device=x.device)
        if pool else None
    )
    lib = library()
    err = lib.st_conv3x3_fwd(
        _ptr(x), _ptr(w), _ptr(b), _ptr(out_y), _ptr(out_m), _ptr(out_p),
        h, wd, k, n, conv_tile(h, wd, n), _stream(),
    )
    _check_launch(lib, err, "conv3x3_fwd")
    count.n += 1
    return out_y, out_m, out_p


def taps(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO taps, or a bias, as the contiguous bf16 operand
    of :func:`conv3x3_fwd`, prepared once per tensor (``_weights``)."""
    return _weights.bf16(w)


def taps_transposed(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO taps -> the backward-data operand (3, 3, Cout,
    Cin): spatially flipped, channels swapped, bf16, contiguous; prepared
    once per tensor (``_weights``)."""
    return _weights.taps_transposed(w)


def conv3x3_bwd_data(
    dy: Optional[torch.Tensor], w_t: torch.Tensor, *, hw: Tuple[int, int], count: LaunchCount,
    in_mask: Optional[torch.Tensor] = None, unpool: bool = False,
    pre_add: Optional[torch.Tensor] = None, pre_gate: Optional[torch.Tensor] = None,
    add: Optional[torch.Tensor] = None, gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Transposed 3x3 SAME conv of a cotangent: (H, W, N) bf16 out of ``dy``
    (H, W, K) — or (H/2, W/2, K) when ``unpool``; None reads as zero — with
    ``w_t`` from :func:`taps_transposed`. Prologue, per staged element:
    ``unpool`` (x0.25, duplicated rows and columns), the int8 ``in_mask``
    gate, ``+ pre_add`` (fp32, (H, W, K)), zero where ``pre_gate`` (bf16,
    (H, W, K)) <= 0, and one bf16 rounding when ``pre_add`` or ``pre_gate``
    is given. Epilogue: ``+ add`` (fp32), then the ReLU gate ``gate > 0``,
    then the bf16 store."""
    h, wd = hw
    k, n = w_t.shape[2], w_t.shape[3]
    if unpool and (h % 2 or wd % 2):
        raise ValueError(f"unpooling needs even H and W, got {(h, wd)}")
    if dy is not None:
        _require(dy, "dy", torch.bfloat16, (h // 2, wd // 2, k) if unpool else (h, wd, k))
    _require(w_t, "w_t", torch.bfloat16, (3, 3, k, n))
    if in_mask is not None:
        _require(in_mask, "in_mask", torch.int8, (h, wd, k))
    if pre_add is not None:
        _require(pre_add, "pre_add", torch.float32, (h, wd, k))
    if pre_gate is not None:
        _require(pre_gate, "pre_gate", torch.bfloat16, (h, wd, k))
    if add is not None:
        _require(add, "add", torch.float32, (h, wd, n))
    if gate is not None:
        _require(gate, "gate", torch.bfloat16, (h, wd, n))
    out = torch.empty((h, wd, n), dtype=torch.bfloat16, device=w_t.device)
    lib = library()
    err = lib.st_conv3x3_bwd_data(
        _ptr(dy), _ptr(in_mask), int(unpool), _ptr(pre_add), _ptr(pre_gate), _ptr(w_t),
        _ptr(add), _ptr(gate), _ptr(out), h, wd, k, n, conv_tile(h, wd, n), _stream(),
    )
    _check_launch(lib, err, "conv3x3_bwd_data")
    count.n += 1
    return out


def _window(cols: Optional[Tuple[int, int, int]], m: int) -> Tuple[int, int, int]:
    """``(W, clo, chi)`` of a Gram column window for the C entry points
    ((0, 0, 0): none). Row r of the (M, C) operand is pixel column r % W."""
    if cols is None:
        return 0, 0, 0
    w, clo, chi = (int(v) for v in cols)
    if w <= 0 or m % w:
        raise ValueError(f"a column window needs W > 0 dividing the {m} rows, got W={w}")
    return w, clo, chi


def _row_span(rows: Optional[Tuple[int, int, int]], m: int) -> Tuple[int, int]:
    """``(first, end)`` operand rows of a pixel-row window ``rows = (W, lo,
    hi)``: image rows ``[lo, hi)`` of an (M = H*W, C) operand are its rows
    ``[lo*W, hi*W)``, a contiguous span, so the kernels need no window of
    their own."""
    if rows is None:
        return 0, m
    w, lo, hi = (int(v) for v in rows)
    if w <= 0 or m % w or not 0 <= lo <= hi <= m // w:
        raise ValueError(f"a row window needs W > 0 dividing the {m} rows and 0 <= lo <= hi "
                         f"<= {m // w if w > 0 else '?'}, got {rows}")
    return lo * w, hi * w


def gram(
    f: torch.Tensor, *, count: LaunchCount, cols: Optional[Tuple[int, int, int]] = None,
    rows: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Unnormalized fp32 Gram ``F^T F`` of an (M, C) bf16 activation; with
    ``cols = (W, clo, chi)`` only the rows whose pixel column ``r % W`` lies
    in ``[clo, chi)`` count, and with ``rows = (W, lo, hi)`` only image rows
    ``[lo, hi)`` (the span ``F[lo*W:hi*W]``; a mesh shard's own rows)."""
    m, c = f.shape
    _require(f, "f", torch.bfloat16, (m, c))
    first, end = _row_span(rows, m)
    f, m = f[first:end], end - first
    if c % 64:
        raise ValueError(f"Gram channels must be a multiple of 64, got {c}")
    win = _window(cols, m)
    lib = library()
    chunk = gram_rows_per_chunk(m, c)
    part = torch.empty((-(-m // chunk), c, c), dtype=torch.float32, device=f.device)
    out = torch.empty((c, c), dtype=torch.float32, device=f.device)
    err = lib.st_gram(_ptr(f), _ptr(part), _ptr(out), m, c, chunk, *win, _stream())
    _check_launch(lib, err, "gram")
    count.n += 1
    return out


def gram_fs(
    f: torch.Tensor, s: torch.Tensor, *, count: LaunchCount, relu_gate: bool = False,
    out_bf16: bool = False, cols: Optional[Tuple[int, int, int]] = None,
    rows: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """``F S`` for F (M, C) bf16 and S (C, C) bf16: fp32 (M, C); with
    ``out_bf16`` rounded once to bf16; with ``relu_gate`` the bf16
    ``where(F > 0, F S, 0)``. With ``cols`` (as in :func:`gram`) the rows
    outside the column window are zero; with ``rows`` (as in :func:`gram`)
    the kernel runs on the window's span only and writes it into the
    output, whose rows outside the span are set to zero here."""
    m, c = f.shape
    _require(f, "f", torch.bfloat16, (m, c))
    _require(s, "s", torch.bfloat16, (c, c))
    if c % 64:
        raise ValueError(f"Gram channels must be a multiple of 64, got {c}")
    half = relu_gate or out_bf16
    out = torch.empty((m, c), dtype=torch.bfloat16 if half else torch.float32, device=f.device)
    first, end = _row_span(rows, m)
    if rows is not None:
        out[:first].zero_()
        out[end:].zero_()
    fw, ow = f[first:end], out[first:end]
    win = _window(cols, end - first)
    lib = library()
    err = lib.st_gram_fs(_ptr(fw), _ptr(s), None if half else _ptr(ow), _ptr(ow) if half else None,
                         int(relu_gate), end - first, c, *win, _stream())
    _check_launch(lib, err, "gram_fs")
    count.n += 1
    return out


#: Threads per block of ``csrc/epilogue.cu`` and the 16-byte loads per operand
#: that a thread has in flight at most; ``selfcheck.loss_model_matches`` holds
#: both to the built library.
SSE_THREADS = 256
SSE_UNROLL = 4
#: Up to this many 16-byte vectors (a 64 x 64 fp32 Gram) one block computes
#: the whole loss, with no partial sums.
SSE_ONE_BLOCK_VECTORS = SSE_THREADS * 4
#: A thread takes a second vector per step only once the card has this many
#: blocks per SM, and the forward's grid stops at SSE_BLOCKS_PER_SM per SM
#: (beyond that its blocks loop).
SSE_MIN_BLOCKS_PER_SM = 4
SSE_BLOCKS_PER_SM = 8


def cast_blocks(n: int, itemsize: int) -> int:
    """Blocks of the loss backward (``scale_cast``) for ``n`` elements of
    ``itemsize`` bytes: one 16-byte vector a thread while that gives fewer
    than :data:`SSE_MIN_BLOCKS_PER_SM` blocks per SM, then more vectors a
    thread, up to :data:`SSE_UNROLL`."""
    nvec = max(1, n * itemsize // 16)
    per_thread = min(max(nvec // (SSE_THREADS * SM_COUNT * SSE_MIN_BLOCKS_PER_SM), 1), SSE_UNROLL)
    return -(-nvec // (SSE_THREADS * per_thread))


def sse_blocks(n: int, itemsize: int) -> int:
    """Blocks of the loss forward, which is also its count of partial sums:
    one up to :data:`SSE_ONE_BLOCK_VECTORS`, else as :func:`cast_blocks` up to
    :data:`SSE_BLOCKS_PER_SM` per SM."""
    if n * itemsize // 16 <= SSE_ONE_BLOCK_VECTORS:
        return 1
    return min(cast_blocks(n, itemsize), SM_COUNT * SSE_BLOCKS_PER_SM)


#: Threads and rows per block of ``csrc/tv.cu``.
TV_THREADS = 256
TV_ROWS = 4
_MAX_GRID_Y = 65535


def tv_grid(h: int, wc: int, c: int) -> Tuple[int, int, int]:
    """``(vec, chunks, groups)`` of ``csrc/tv.cu`` for an (h, wc) image of
    ``c`` channels: columns per thread (4 for an RGB image whose row is a
    multiple of 4 floats, else 1) and the grid of column chunks x row groups,
    whose product is the count of partial sums."""
    vec = 4 if c == 3 and wc % 4 == 0 else 1
    groups = -(-h // TV_ROWS)
    if groups > _MAX_GRID_Y:
        raise ValueError(f"tv takes images up to {_MAX_GRID_Y * TV_ROWS} rows, got {h}")
    return vec, -(-wc // (TV_THREADS * vec)), groups


# (device index, stream) -> [ticket counter (1,) int32, partial sums (n,) fp32]
_REDUCE_SCRATCH = {}


def _reduce_scratch(device: torch.device, nblocks: int):
    """The ticket counter and the partial-sum buffer of the single-launch
    reductions (``st::finish_mean``), one pair per device and stream: the
    counter is zeroed once, here, and every kernel leaves it zero; kernels
    of one stream run in order, so they can share it, and two streams never
    do. Allocated outside any call, so a CUDA graph captured later replays
    with the same addresses. The partial buffer grows when a grid needs it."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    entry = _REDUCE_SCRATCH.get(key)
    if entry is None:
        entry = [torch.zeros((1,), dtype=torch.int32, device=device),
                 torch.empty((max(nblocks, 16384),), dtype=torch.float32, device=device)]
        _REDUCE_SCRATCH[key] = entry
    if entry[1].numel() < nblocks:
        entry[1] = torch.empty((nblocks,), dtype=torch.float32, device=device)
    return entry


def cotangent(ct: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A scalar loss's cotangent as the kernels read it: one contiguous fp32
    value on ``device``, made without reading it on the host (no copy at all
    for the fp32 0-d tensor autograd passes)."""
    if ct.numel() != 1:
        raise ValueError(f"a scalar loss takes a scalar cotangent, got shape {tuple(ct.shape)}")
    return ct.to(device=device, dtype=torch.float32).reshape(()).contiguous()


def _require_cotangent(ct: torch.Tensor) -> None:
    # autograd's tensor: 4-byte aligned only, and the kernels read it as one scalar
    if not (ct.is_cuda and ct.dtype == torch.float32 and ct.dim() == 0):
        raise ValueError("the cotangent must be a 0-d fp32 CUDA tensor (see cotangent())")


def tv(x2d: torch.Tensor, c: int, *, count: LaunchCount) -> torch.Tensor:
    """The 0-d fp32 TV mean of an (H, W*C) fp32 image, one launch."""
    h, wc = x2d.shape
    _require(x2d, "x", torch.float32, (h, wc))
    vec, chunks, groups = tv_grid(h, wc, c)
    counter, partial = _reduce_scratch(x2d.device, chunks * groups)
    out = torch.empty((), dtype=torch.float32, device=x2d.device)
    lib = library()
    err = lib.st_tv(_ptr(x2d), _ptr(partial), _ptr(counter), _ptr(out), h, wc, c, vec,
                    float(h * wc), _stream())
    _check_launch(lib, err, "tv")
    count.n += 1
    return out


def tv_grad(x2d: torch.Tensor, c: int, ct: torch.Tensor, *, count: LaunchCount) -> torch.Tensor:
    """The TV gradient of an (H, W*C) fp32 image (the 5-point stencil) times
    ``ct / numel``, ``ct`` from :func:`cotangent`, one launch."""
    h, wc = x2d.shape
    _require(x2d, "x", torch.float32, (h, wc))
    _require_cotangent(ct)
    vec, _, _ = tv_grid(h, wc, c)
    grad = torch.empty_like(x2d)
    lib = library()
    err = lib.st_tv_grad(_ptr(x2d), _ptr(ct), _ptr(grad), h, wc, c, vec, float(h * wc), _stream())
    _check_launch(lib, err, "tv_grad")
    count.n += 1
    return grad


def _require_pair(f: torch.Tensor, t: torch.Tensor, what: str) -> None:
    if f.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or fp32 tensors, got {f.dtype}")
    if f.numel() == 0:
        raise ValueError(f"{what} takes at least one element")
    _require(f, "f", f.dtype, tuple(f.shape))
    _require(t, "t", f.dtype, tuple(f.shape))


def sse(f: torch.Tensor, t: torch.Tensor, *, count: LaunchCount) -> torch.Tensor:
    """The 0-d fp32 ``mean((f - t)^2)`` of two equally shaped tensors, both
    bf16 or both fp32, summed from the unrounded difference, one launch."""
    _require_pair(f, t, "sse")
    n = f.numel()
    nblocks = sse_blocks(n, f.element_size())
    counter, partial = _reduce_scratch(f.device, nblocks)
    out = torch.empty((), dtype=torch.float32, device=f.device)
    lib = library()
    err = lib.st_sse(_ptr(f), _ptr(t), _ptr(partial), _ptr(counter), _ptr(out), n, float(n),
                     nblocks, int(f.dtype == torch.bfloat16), _stream())
    _check_launch(lib, err, "sse")
    count.n += 1
    return out


def scale_cast(f: torch.Tensor, t: torch.Tensor, ct: torch.Tensor, *,
               count: LaunchCount) -> torch.Tensor:
    """The gradient of :func:`sse` to ``f``: ``round(f - t) * ((2 ct) /
    numel)`` in their dtype (bf16 or fp32) — the difference rounded once to
    the dtype, multiplied in fp32, rounded once more; ``ct`` from
    :func:`cotangent`; one launch."""
    _require_pair(f, t, "scale_cast")
    _require_cotangent(ct)
    out = torch.empty_like(f)
    n = f.numel()
    lib = library()
    err = lib.st_scale_cast(_ptr(f), _ptr(t), _ptr(ct), _ptr(out), n, float(n),
                            cast_blocks(n, f.element_size()), int(f.dtype == torch.bfloat16),
                            _stream())
    _check_launch(lib, err, "scale_cast")
    count.n += 1
    return out


def noop() -> None:
    """Launches an empty kernel: the floor of any launch on the card."""
    lib = library()
    _check_launch(lib, lib.st_noop(_stream()), "noop")


_B1_C = 64  # channels of VGG block 1, fixed in csrc/block1.cu

#: Output pixels per tile of ``csrc/block1.cu`` (rows, columns) and its
#: threads per block; at most :data:`SM_COUNT` persistent blocks walk the tiles.
BLOCK1_TILE = (16, 16)
BLOCK1_THREADS = 256
#: bf16 elements of a padded shared-memory row (64 channels + 16 bytes).
BLOCK1_ROW = _B1_C + 8
#: Rows of the conv1_1 taps as the kernels read them (27 padded to 32).
BLOCK1_K1_ROWS = 32


def block1_tiles(h: int, w: int) -> int:
    """16x16-pixel tiles of an (h, w) image, ragged edges included."""
    th, tw = BLOCK1_TILE
    return -(-h // th) * -(-w // tw)


def block1_tiles_per_block(h: int, w: int) -> int:
    """Tiles that one persistent block of ``csrc/block1.cu`` walks."""
    return -(-block1_tiles(h, w) // SM_COUNT)


def block1_blocks(h: int, w: int) -> int:
    """Blocks of a block-1 launch, which is also the number of (64, 64) Gram
    partials of its forward: at most one per SM, the last with a short run."""
    return -(-block1_tiles(h, w) // block1_tiles_per_block(h, w))


def block1_smem(full: bool, backward: bool) -> int:
    """Dynamic shared memory of a block of ``csrc/block1.cu``, in bytes.
    Rows are 144 bytes (:data:`BLOCK1_ROW` bf16). Always resident: the nine
    conv1_2 taps (9 x 64 rows). Forward, tail: two haloed 18x18-pixel r1
    tiles. Forward, full: one r1 tile, the 336 patch rows of 80 bytes, the
    32 rows of conv1_1 taps, the 20-row image tile of 128 bytes a row and
    the fp32 bias. Backward: S (64 rows), two haloed cotangent tiles, the
    256 own pixels of r1, and for full the conv1_1 taps."""
    th, tw = BLOCK1_TILE
    row = BLOCK1_ROW * 2
    taps, tile = 9 * _B1_C * row, (th + 2) * (tw + 2) * row
    k1 = BLOCK1_K1_ROWS * row
    if backward:
        return taps + _B1_C * row + 2 * tile + th * tw * row + (k1 if full else 0)
    if not full:
        return taps + 2 * tile
    patches = -(-(th + 2) * (tw + 2) // 16) * 16 * (BLOCK1_K1_ROWS + 8) * 2
    return taps + tile + patches + k1 + (th + 4) * 128 + _B1_C * 4


def block1_fwd(
    src: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor, *, count: LaunchCount,
    k1: Optional[torch.Tensor] = None, b1: Optional[torch.Tensor] = None,
):
    """Block 1 forward in one launch (plus the Gram's reduce pass). With
    ``k1`` (32, 64) bf16 (``_weights.conv1_taps``) and ``b1`` (64,) fp32,
    ``src`` is the (H, W, 3) bf16 preprocessed image (``block1_full``) and
    r1 = relu(conv1_1) is written; without them ``src`` is r1 (H, W, 64) bf16
    itself (``block1_tail``). ``k2`` (3, 3, 64, 64) bf16, ``b2`` (64,) fp32.
    Returns ``(pool1 (H/2, W/2, 64) bf16, unnormalized Gram of r1 (64, 64)
    fp32, r1, int8 mask (H, W, 64) of conv1_2's pre-activation > 0)``."""
    full = k1 is not None
    h, w, cin = src.shape
    _require(src, "src", torch.bfloat16, (h, w, 3 if full else _B1_C))
    if h % 2 or w % 2:
        raise ValueError(f"block 1 needs even H and W, got {(h, w)}")
    _require(k2, "k2", torch.bfloat16, (3, 3, _B1_C, _B1_C))
    _require(b2, "b2", torch.float32, (_B1_C,))
    if full:
        _require(k1, "k1", torch.bfloat16, (BLOCK1_K1_ROWS, _B1_C))
        _require(b1, "b1", torch.float32, (_B1_C,))
    dev = src.device
    r1 = torch.empty((h, w, _B1_C), dtype=torch.bfloat16, device=dev) if full else src
    mask = torch.empty((h, w, _B1_C), dtype=torch.int8, device=dev)
    pool = torch.empty((h // 2, w // 2, _B1_C), dtype=torch.bfloat16, device=dev)
    gram = torch.empty((_B1_C, _B1_C), dtype=torch.float32, device=dev)
    lib = library()
    part = torch.empty((lib.st_block1_partials(h, w), _B1_C, _B1_C), dtype=torch.float32,
                       device=dev)
    err = lib.st_block1_fwd(
        _ptr(src) if full else None, _ptr(k1), _ptr(b1), _ptr(r1), _ptr(k2), _ptr(b2),
        _ptr(mask), _ptr(pool), _ptr(part), _ptr(gram), h, w, _stream(),
    )
    _check_launch(lib, err, "block1_fwd")
    count.n += 1
    return pool, gram, r1, mask


def block1_bwd(
    d_pool: torch.Tensor, mask: torch.Tensor, r1: torch.Tensor, s: torch.Tensor,
    k2t: torch.Tensor, *, count: LaunchCount, k1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Block 1 backward in one launch, from the pooled cotangent (H/2, W/2, 64)
    bf16, the forward's int8 mask and r1, ``s`` = (dG + dG^T)/(H*W) as (64, 64)
    bf16 and ``k2t`` from :func:`taps_transposed`. Without ``k1``: d_r1
    (H, W, 64) bf16 (``block1_tail``). With ``k1`` (32, 64) bf16, as in the
    forward: the patch cotangents of conv1_1, tap-major (9, H, W, 3) bf16
    (``block1_full``), for :func:`block1_col2im`."""
    h, w, _ = r1.shape
    _require(r1, "r1", torch.bfloat16, (h, w, _B1_C))
    _require(mask, "mask", torch.int8, (h, w, _B1_C))
    _require(d_pool, "d_pool", torch.bfloat16, (h // 2, w // 2, _B1_C))
    _require(s, "s", torch.bfloat16, (_B1_C, _B1_C))
    _require(k2t, "k2t", torch.bfloat16, (3, 3, _B1_C, _B1_C))
    if k1 is not None:
        _require(k1, "k1", torch.bfloat16, (BLOCK1_K1_ROWS, _B1_C))
    shape = (h, w, _B1_C) if k1 is None else (9, h, w, 3)
    out = torch.empty(shape, dtype=torch.bfloat16, device=r1.device)
    lib = library()
    err = lib.st_block1_bwd(_ptr(d_pool), _ptr(mask), _ptr(r1), _ptr(s), _ptr(k2t), _ptr(k1),
                            _ptr(out), h, w, _stream())
    _check_launch(lib, err, "block1_bwd")
    count.n += 1
    return out


def block1_col2im(dpt: torch.Tensor) -> torch.Tensor:
    """Tap-major (9, H, W, 3) bf16 patch cotangents -> the (H, W, 3) bf16
    image cotangent: each tap gathered back shifted, summed in fp32 in tap
    order and rounded once. A small pass that belongs to ``block1_full``'s
    backward and is not counted as a launch of its own."""
    _, h, w, _ = dpt.shape
    _require(dpt, "dpt", torch.bfloat16, (9, h, w, 3))
    out = torch.empty((h, w, 3), dtype=torch.bfloat16, device=dpt.device)
    lib = library()
    _check_launch(lib, lib.st_block1_col2im(_ptr(dpt), _ptr(out), h, w, _stream()), "block1_col2im")
    return out
