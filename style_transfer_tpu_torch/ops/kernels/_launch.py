"""Typed launchers for the C entry points of the kernel library.

Each launcher checks device, dtype, shape, contiguity and alignment, allocates
every output (and scratch) with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch was refused, and adds one to the caller's
:class:`~style_transfer_tpu_torch.ops.kernels._build.LaunchCount` under the
launcher's name and the shape its operations and bytes follow from:

- ``conv3x3_fwd``: ``(H, W, K, N, y, mask, pool, tile)``, K input and N
  output channels, which outputs are written, and the tile configuration
  the launch took (a key of :data:`CONV_TILES`; :data:`CONV_WGMMA_TILE` is
  the warpgroup-MMA tile);
- ``conv3x3_bwd_data``: ``(H, W, K, N, unpool, dy, in_mask, pre_add,
  pre_gate, add, gate, tile)``, K the cotangent's channels and N the
  output's, which operands are given, and the tile as above;
- ``gram``: ``(M, C, W, clo, chi, cfg)``, M the rows summed (a row
  window's span), the column window (0, 0, 0: none), and the configuration
  the launch took, ``gram_config(M, C)`` (a key of :data:`GRAM_CONFIGS`);
- ``gram_fs``: ``(M, C, W, clo, chi, relu_gate, bf16 out, cfg)``, ``cfg``
  the width of its output tiles, ``gram_fs_width(M, C)`` (64 or 128);
- ``tv``, ``tv_grad``: ``(H, W*C, C)``; ``sse``, ``scale_cast``:
  ``(elements, bytes per element)``;
- ``block1_fwd``, ``block1_bwd``: ``(H, W, full)``, ``full`` with conv1_1;
- ``conv1x1_fwd``: ``(H, W, K, N, stride, residual, relu)``, H x W the
  input's extent (the output's is ``ceil(H / stride)`` x ``ceil(W /
  stride)``), K input and N output channels, whether a residual is added
  and the ReLU applied (the bias always is). The tile width the launch
  takes is ``conv1x1_width(N)``, so the shape says it (as it does for
  ``conv1x1_bwd_data``: ``conv1x1_width(N, gate)``);
- ``conv1x1_bwd_data``: ``(H, W, K, N, add, add_sub, gate)``, H x W the
  extent of the cotangent and of the output, K the cotangent's channels
  and N the output's, whether an ``add`` operand is given (at half the
  extent with ``add_sub``) and a gate;
- ``im2col``: ``(H, W, C, kh, kw, stride, Kp)``, the input's extent and
  channels, the kernel, the stride and the padded column count (the
  padding is half the kernel); ``col2im``: ``(H, W, C, kh, kw, stride, Kp,
  gate)``, H x W the extent it writes;
- ``maxpool_fwd``: ``(H, W, C)``, the input's; ``maxpool_bwd``: ``(H, W,
  C, dy, add, gate)``, the extent it writes and which operands are given;
- ``relu_gate``: ``(elements,)``.

Only CUDA tensors get here; nothing in this module runs on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
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
#: columns, output channels, warps, pipeline stages, blocks per SM it is
#: built for). ``chip_smoke.py`` holds the table against the built library
#: (``st_conv3x3_tile_info``).
CONV_TILES = {
    0: (16, 16, 128, 12, 4, 1),
    1: (16, 16, 64, 8, 3, 2),
    2: (8, 8, 64, 4, 2, 4),
    3: (16, 16, 8, 8, 2, 2),
}
#: The tile on the warpgroup MMA (wgmma): two consumer warpgroups and one
#: producer warpgroup, one block an SM; the others run ``mma.sync``.
CONV_WGMMA_TILE = 0


def conv_tile_smem(tile: int) -> int:
    """Dynamic shared memory of a block of tile configuration ``tile``, in
    bytes: the larger of its pipeline stages and the fp32 output tile of the
    epilogue (rows padded by 32 bytes). An ``mma.sync`` stage holds the
    haloed bf16 input tile at 48 bytes a pixel and the 9 x 16 weight rows,
    padded by 16 bytes where they are wider than one ldmatrix row. A
    warpgroup stage holds the same input at 32 bytes a pixel (two 8-channel
    planes), rounded up to 1024 bytes, and the weights unpadded in 1024-byte
    swizzle atoms; two 8-byte mbarriers a stage follow, and the kernel asks
    1024 bytes more to align its start."""
    th, tw, bn, _, stages, _ = CONV_TILES[tile]
    if tile == CONV_WGMMA_TILE:
        a_bytes = -(-(th + 2) * (tw + 2) * CONV_KC * 2 // 1024) * 1024
        b_bytes = 9 * CONV_KC * bn * 2
        return max(stages * (a_bytes + b_bytes), th * tw * (bn + 8) * 4) + 16 * stages + 1024
    a_bytes = (th + 2) * (tw + 2) * (CONV_KC + 8) * 2
    b_bytes = 9 * CONV_KC * (bn if bn == 8 else bn + 8) * 2
    return max(stages * (a_bytes + b_bytes), th * tw * (bn + 8) * 4)


def conv_blocks(tile: int, h: int, w: int, n: int) -> int:
    """Blocks of the grid that tile configuration ``tile`` gives an (h, w)
    image with ``n`` output channels."""
    th, tw, bn = CONV_TILES[tile][:3]
    return -(-h // th) * -(-w // tw) * -(-n // bn)


def conv_tile(h: int, w: int, n: int) -> int:
    """The tile configuration for an (h, w) image and ``n`` output channels,
    by shape alone: the n8 tile for up to 8 channels (conv1_1's
    backward-data); for more than 64 channels the warpgroup tile
    (:data:`CONV_WGMMA_TILE`, 16x16 pixels x 128 channels, one block an SM)
    wherever its grid gives more than a quarter of the card's SMs a block,
    else the small 8x8-pixel 64-channel tile; for 9-64 channels the
    16x16-pixel 64-channel tile, unless that leaves more than a quarter of
    the SMs without a block, where the small tile fills them. On the H100
    (``chip_smoke.py``'s ``conv_rates`` times each wide shape on both
    tiles) the warpgroup tile wins from 64 blocks up (64x64 with 512
    channels), and at 32 blocks and fewer (the 256 px scale's deep layers,
    conv5_1 at 32x32) the small tile's 8-16 times as many blocks are as
    fast or faster."""
    if n <= 8:
        return 3
    if n > 64:
        return CONV_WGMMA_TILE if 4 * conv_blocks(CONV_WGMMA_TILE, h, w, n) > SM_COUNT else 2
    return 1 if 4 * conv_blocks(1, h, w, n) >= 3 * SM_COUNT else 2


#: Rows of F one step of ``csrc/gram.cu``'s F^T F kernel multiplies (its
#: ``GR``, a stage of its ring): the unit its blocks split the rows by; and
#: the rows of an F S tile (its ``FS_BM``). ``selfcheck.gram_model_matches``
#: holds both against the built library (``st_gram_info``).
GRAM_ROW_STEP = 64
GRAM_FS_ROWS = 128
#: The configurations of the F^T F kernel: index -> (edge of its output
#: tiles, rows in chunks). Stream-K (not in chunks): the blocks split the
#: (tile, step) pairs evenly, each a contiguous run. In chunks: a block a
#: tile of a chunk of rows, the chunk's blocks side by side over its rows.
GRAM_CONFIGS = {0: (64, False), 1: (128, False), 2: (128, True)}
#: Least steps of :data:`GRAM_ROW_STEP` rows a block of the F^T F kernel takes.
GRAM_MIN_STEPS = 2
#: Up to this many elements of F (4 MiB of bf16) the F^T F kernel takes
#: 64-wide tiles at any c.
GRAM_SMALL_ELEMENTS = 1 << 21


def gram_config(m: int, c: int) -> int:
    """The F^T F configuration for an (m, c) activation, by shape alone (a
    key of :data:`GRAM_CONFIGS`): 64-wide tiles (one warpgroup on m64n64)
    where c is not a multiple of 128 (c = 64: the whole Gram one tile) or F
    is small (:data:`GRAM_SMALL_ELEMENTS`); else 128-wide tiles (two
    warpgroups, an m64n128 product each), in chunks of rows where the Gram
    has from 2 to as many tiles as the card has SMs (c = 256 .. 1920), else
    split evenly (one tile, or more tiles than SMs). Timed on an H100
    (``PERF.md`` §6): the chunks took 256 channels at 262144 rows
    from 89 to 59 us, 512 at 65536 from 84 to 40 and 1024 at 16384 from 55
    to 40; 128-wide tiles beat 64-wide ones at c = 128 from 65536 rows
    (0.0125 against 0.0136 ms) and at every c from 16384 x 256 up; below,
    at 2-10 us a launch, 64-wide tiles won by 0.1-2 us or tied."""
    if c % 128 or m * c <= GRAM_SMALL_ELEMENTS:
        return 0
    return 2 if 1 < gram_tiles(c, 128) <= SM_COUNT else 1


def gram_tiles(c: int, tile: int = 64) -> int:
    """tile x tile tiles of the (c, c) Gram on and above the diagonal."""
    t = c // tile
    return t * (t + 1) // 2


def gram_chunks(m: int, c: int) -> int:
    """Chunks of rows of the F^T F kernel for an (m, c) activation (0: the
    stream-K split): as many as the SMs hold a block for each tile of a
    chunk, each chunk :data:`GRAM_MIN_STEPS` steps or more where m allows."""
    tile, chunked = GRAM_CONFIGS[gram_config(m, c)]
    if not chunked:
        return 0
    steps = -(-m // GRAM_ROW_STEP)
    return max(1, min(SM_COUNT // gram_tiles(c, tile), steps // GRAM_MIN_STEPS))


def gram_blocks(m: int, c: int) -> int:
    """Blocks of the F^T F kernel for an (m, c) activation: in chunks, the
    tiles times the chunks; else one an SM, as long as each takes
    :data:`GRAM_MIN_STEPS` steps of the (tile, step) pairs. Also the partial
    tiles its scratch holds: a tile's first piece goes into the output, and
    a block writes at most one other piece (stream-K: where its run starts
    inside a tile, in slot block - 1; in chunks: its own, in slot block)."""
    tile = GRAM_CONFIGS[gram_config(m, c)][0]
    chunks = gram_chunks(m, c)
    if chunks:
        return chunks * gram_tiles(c, tile)
    work = gram_tiles(c, tile) * -(-m // GRAM_ROW_STEP)
    return max(1, min(SM_COUNT, work // GRAM_MIN_STEPS))


@functools.lru_cache(maxsize=256)
def _gram_plan(m: int, c: int) -> Tuple[int, int, int, int]:
    """(configuration, tile edge, blocks, chunks) of the F^T F kernel for an
    (m, c) activation, worked out once per shape: a step launches the same
    few shapes every time."""
    cfg = gram_config(m, c)
    return cfg, GRAM_CONFIGS[cfg][0], gram_blocks(m, c), gram_chunks(m, c)


def gram_fs_width(m: int, c: int) -> int:
    """The F S configuration for an (m, c) activation, by shape alone: the
    width of its :data:`GRAM_FS_ROWS`-row output tiles, 128 where c is a
    multiple of 256 or more of 128 and the 128-wide tiles outnumber the
    SMs, else 64. Timed on an H100 (``PERF.md`` §6): at c = 128,
    64-wide tiles won by 2-5% from 16384 to 262144 rows and tied at 2^20;
    with as many 128-wide tiles as SMs or fewer (4096 x 256, 256 .. 4096 x
    512), 64-wide ones won by 0.3-4.7 us, the gated output the most; with
    more, 128-wide ones won by 3-35% (fp32, bf16 and gated), but for the
    bf16 output at 262144 x 256 (7% the other way)."""
    if c % 128 or c == 128:
        return 64
    return 128 if -(-m // GRAM_FS_ROWS) * (c // 128) > SM_COUNT else 64


def _ptr(t: Optional[torch.Tensor]):
    # an int or None: ctypes converts either for a c_void_p parameter
    return None if t is None else t.data_ptr()


def _stream():
    # PyTorch's current stream on the current device, read through the two C
    # calls that torch.cuda.current_stream() ends in: its Python path checks
    # CUDA's availability on every call, about 10 us of host time a launch
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _check_launch(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.st_error_string(err).decode()}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if (t.is_cuda and t.dtype == dtype and t.shape == tuple(shape) and t.is_contiguous()
            and not t.data_ptr() % 16):
        return  # the launch's common case, in one test
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


def _tile(tile: Optional[int], h: int, w: int, n: int) -> int:
    if tile is None:
        return conv_tile(h, w, n)
    if tile not in CONV_TILES:
        raise ValueError(f"no tile configuration {tile}; the table has {sorted(CONV_TILES)}")
    return tile


def conv3x3_fwd(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, count: LaunchCount,
    y: bool = False, mask: bool = False, pool: bool = False, tile: Optional[int] = None,
):
    """relu(conv3x3_same(x, w) + b) for x (H, W, K) bf16, w (3, 3, K, N) bf16,
    b (N,) bf16. Returns ``(y, mask, pool)``, None where not requested: the
    bf16 ReLU output (H, W, N), its int8 mask ``pre > 0`` (H, W, N), and its
    bf16 2x2 average pool (H/2, W/2, N). ``tile`` forces a tile
    configuration in place of :func:`conv_tile`'s (the edge cases run every
    tile at every size)."""
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
    tile = _tile(tile, h, wd, n)
    lib = library()
    err = lib.st_conv3x3_fwd(
        _ptr(x), _ptr(w), _ptr(b), _ptr(out_y), _ptr(out_m), _ptr(out_p),
        h, wd, k, n, tile, _stream(),
    )
    _check_launch(lib, err, "conv3x3_fwd")
    count.add("conv3x3_fwd", (h, wd, k, n, y, mask, pool, tile))
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
    tile: Optional[int] = None,
) -> torch.Tensor:
    """Transposed 3x3 SAME conv of a cotangent: (H, W, N) bf16 out of ``dy``
    (H, W, K) — or (H/2, W/2, K) when ``unpool``; None reads as zero — with
    ``w_t`` from :func:`taps_transposed`. Prologue, per staged element:
    ``unpool`` (x0.25, duplicated rows and columns), the int8 ``in_mask``
    gate, ``+ pre_add`` (fp32, (H, W, K)), zero where ``pre_gate`` (bf16,
    (H, W, K)) <= 0, and one bf16 rounding when ``pre_add`` or ``pre_gate``
    is given. Epilogue: ``+ add`` (fp32), then the ReLU gate ``gate > 0``,
    then the bf16 store. ``tile`` as in :func:`conv3x3_fwd`."""
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
    tile = _tile(tile, h, wd, n)
    lib = library()
    err = lib.st_conv3x3_bwd_data(
        _ptr(dy), _ptr(in_mask), int(unpool), _ptr(pre_add), _ptr(pre_gate), _ptr(w_t),
        _ptr(add), _ptr(gate), _ptr(out), h, wd, k, n, tile, _stream(),
    )
    _check_launch(lib, err, "conv3x3_bwd_data")
    count.add("conv3x3_bwd_data", (h, wd, k, n, unpool, dy is not None, in_mask is not None,
                                   pre_add is not None, pre_gate is not None, add is not None,
                                   gate is not None, tile))
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
    cfg, tile, blocks, chunks = _gram_plan(m, c)
    part = torch.empty((blocks, tile, tile), dtype=torch.float32, device=f.device)
    out = torch.empty((c, c), dtype=torch.float32, device=f.device)
    err = lib.st_gram(_ptr(f), _ptr(part), _ptr(out), m, c, tile, blocks, chunks, *win, _stream())
    _check_launch(lib, err, "gram")
    count.add("gram", (m, c) + win + (cfg,))
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
    width = gram_fs_width(end - first, c)
    lib = library()
    err = lib.st_gram_fs(_ptr(fw), _ptr(s), None if half else _ptr(ow), _ptr(ow) if half else None,
                         int(relu_gate), end - first, c, width, *win, _stream())
    _check_launch(lib, err, "gram_fs")
    count.add("gram_fs", (end - first, c) + win + (relu_gate, half, width))
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


def tv(x2d: torch.Tensor, c: int, *, count: LaunchCount,
       numel: Optional[float] = None) -> torch.Tensor:
    """The 0-d fp32 TV mean of an (H, W*C) fp32 image, one launch: the sum
    divided by ``numel`` (default H*W*C; 1 gives the sum itself)."""
    h, wc = x2d.shape
    _require(x2d, "x", torch.float32, (h, wc))
    vec, chunks, groups = tv_grid(h, wc, c)
    counter, partial = _reduce_scratch(x2d.device, chunks * groups)
    out = torch.empty((), dtype=torch.float32, device=x2d.device)
    lib = library()
    err = lib.st_tv(_ptr(x2d), _ptr(partial), _ptr(counter), _ptr(out), h, wc, c, vec,
                    float(h * wc if numel is None else numel), _stream())
    _check_launch(lib, err, "tv")
    count.add("tv", (h, wc, c))
    return out


def tv_grad(x2d: torch.Tensor, c: int, ct: torch.Tensor, *, count: LaunchCount,
            numel: Optional[float] = None) -> torch.Tensor:
    """The TV gradient of an (H, W*C) fp32 image (the 5-point stencil) times
    ``ct / numel`` (default H*W*C), ``ct`` from :func:`cotangent`, one
    launch."""
    h, wc = x2d.shape
    _require(x2d, "x", torch.float32, (h, wc))
    _require_cotangent(ct)
    vec, _, _ = tv_grid(h, wc, c)
    grad = torch.empty_like(x2d)
    lib = library()
    err = lib.st_tv_grad(_ptr(x2d), _ptr(ct), _ptr(grad), h, wc, c, vec,
                         float(h * wc if numel is None else numel), _stream())
    _check_launch(lib, err, "tv_grad")
    count.add("tv_grad", (h, wc, c))
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
    count.add("sse", (n, f.element_size()))
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
    count.add("scale_cast", (n, f.element_size()))
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
    count.add("block1_fwd", (h, w, full))
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
    count.add("block1_bwd", (h, w, k1 is not None))
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


def _opt(t: Optional[torch.Tensor], name: str, dtype: torch.dtype, shape) -> None:
    if t is not None:
        _require(t, name, dtype, shape)


#: Output pixels (rows, columns) of a tile of ``csrc/conv1x1.cu``, the tile
#: widths (output channels) the library builds, its reduction channels per
#: chunk, and its blocks per SM (persistent: one, walking the tiles); the
#: ``cuda`` tests hold them against the built library (``st_conv1x1_info``).
CONV1X1_TILE = (8, 16)
CONV1X1_WIDTHS = (64, 128)
CONV1X1_KC = 64
CONV1X1_BLOCKS_PER_SM = 1


def conv1x1_width(n: int, gate: bool = False) -> int:
    """The tile width ``csrc/conv1x1.cu`` takes for N output channels: 64
    where a 128-wide tile would leave half or more of its columns empty (N =
    64, and the stem's 152 = 128 + 24), and where the tile reads a gate (the
    backward's ReLU gate: a 128-wide tile's output and gate fill 64 KB of
    shared memory, 96 KB with an add, so no more than two tiles' operands
    would be in flight; on an H100, the 25 gated launches of a 2048^2
    ResNet-50 step with N >= 128 take 1.22 ms at 64 against 1.37 at 128);
    else 128. The library builds a gated tile at 64 only."""
    return 64 if -(-n // 128) * 128 - n >= 64 or gate else 128


def strided_hw(h: int, w: int, stride: int) -> Tuple[int, int]:
    """Extent after stride ``stride`` (1 or 2) with half-kernel padding."""
    return -(-h // stride), -(-w // stride)


def _conv1x1(x, w, *, bias, add, gate, relu: bool, stride: int, add_sub: bool):
    h, wd, k = x.shape
    n = w.shape[1]
    _require(x, "x", torch.bfloat16, (h, wd, k))
    _require(w, "w", torch.bfloat16, (k, n))
    if k % 8 or n % 8 or k < 64 or n < 64:
        raise ValueError(f"conv1x1 takes K and N multiples of 8 and at least 64, got {(k, n)}")
    if stride not in (1, 2):
        raise ValueError(f"conv1x1 takes stride 1 or 2, got {stride}")
    ho, wo = strided_hw(h, wd, stride)
    _opt(bias, "bias", torch.bfloat16, (n,))
    _opt(add, "add", torch.bfloat16, strided_hw(ho, wo, 2) + (n,) if add_sub else (ho, wo, n))
    _opt(gate, "gate", torch.bfloat16, (ho, wo, n))
    y = torch.empty((ho, wo, n), dtype=torch.bfloat16, device=x.device)
    lib = library()
    err = lib.st_conv1x1(_ptr(x), _ptr(w), _ptr(bias), _ptr(add), _ptr(gate), _ptr(y), h, wd, k,
                         n, stride, int(relu), int(add_sub), conv1x1_width(n, gate is not None),
                         _stream())
    _check_launch(lib, err, "conv1x1")
    return y


def conv1x1_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, count: LaunchCount,
                stride: int = 1, residual: Optional[torch.Tensor] = None,
                relu: bool = True) -> torch.Tensor:
    """``[relu](x[::stride, ::stride] @ w + b [+ residual])`` for x (H, W, K)
    bf16, w (K, N) bf16 (``_weights.gemm``), b (N,) bf16 and residual
    (ceil(H/stride), ceil(W/stride), N) bf16: the bf16 output."""
    y = _conv1x1(x, w, bias=b, add=residual, gate=None, relu=relu, stride=stride, add_sub=False)
    h, wd, k = x.shape
    count.add("conv1x1_fwd", (h, wd, k, w.shape[1], stride, residual is not None, relu))
    return y


def conv1x1_bwd_data(dy: torch.Tensor, w_t: torch.Tensor, *, count: LaunchCount,
                     add: Optional[torch.Tensor] = None, add_sub: bool = False,
                     gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[gate >] (dy @ w_t [+ add])`` for dy (H, W, K) bf16 and w_t (K, N)
    bf16 (``_weights.gemm_t``): the (H, W, N) bf16 cotangent of a
    convolution's input (or of its im2col columns). ``add`` (H, W, N) bf16,
    or with ``add_sub`` (ceil(H/2), ceil(W/2), N) landing on the even
    pixels (a stride-2 projection's input cotangent); ``gate`` (H, W, N)
    bf16 zeroes where it is <= 0."""
    y = _conv1x1(dy, w_t, bias=None, add=add, gate=gate, relu=False, stride=1, add_sub=add_sub)
    h, wd, k = dy.shape
    count.add("conv1x1_bwd_data", (h, wd, k, w_t.shape[1], add is not None, add_sub,
                                   gate is not None))
    return y


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, kp: int, *,
           count: LaunchCount) -> torch.Tensor:
    """The (Ho, Wo, kp) bf16 columns of x (H, W, C) bf16 for a kh x kw
    convolution of ``stride`` with half-kernel padding: column ``(ky * kw +
    kx) * C + c``, zero beyond kh kw C."""
    h, wd, c = x.shape
    _require(x, "x", torch.bfloat16, (h, wd, c))
    if kp % 8 or kp < kh * kw * c:
        raise ValueError(f"columns must be a multiple of 8 and at least {kh * kw * c}, got {kp}")
    ho, wo = strided_hw(h, wd, stride)
    col = torch.empty((ho, wo, kp), dtype=torch.bfloat16, device=x.device)
    lib = library()
    err = lib.st_im2col(_ptr(x), _ptr(col), h, wd, c, kh, kw, stride, kh // 2, ho, wo, kp,
                        _stream())
    _check_launch(lib, err, "im2col")
    count.add("im2col", (h, wd, c, kh, kw, stride, kp))
    return col


def col2im(dcol: torch.Tensor, hw: Tuple[int, int], c: int, kh: int, kw: int, stride: int, *,
           count: LaunchCount, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adjoint of :func:`im2col`: the (H, W, c) bf16 cotangent of its
    input from the (Ho, Wo, Kp) bf16 cotangent of its columns, each pixel's
    taps summed in fp32 in tap order, zero where ``gate`` (H, W, c) bf16 is
    <= 0."""
    h, wd = hw
    ho, wo = strided_hw(h, wd, stride)
    kp = dcol.shape[2]
    _require(dcol, "dcol", torch.bfloat16, (ho, wo, kp))
    _opt(gate, "gate", torch.bfloat16, (h, wd, c))
    if kp < kh * kw * c:
        raise ValueError(f"columns must be at least {kh * kw * c}, got {kp}")
    if c % 8 and c > 8:
        raise ValueError(f"col2im takes a multiple of 8 channels or at most 8, got {c}")
    dx = torch.empty((h, wd, c), dtype=torch.bfloat16, device=dcol.device)
    lib = library()
    err = lib.st_col2im(_ptr(dcol), _ptr(gate), _ptr(dx), h, wd, c, kh, kw, stride, kh // 2, ho,
                        wo, kp, _stream())
    _check_launch(lib, err, "col2im")
    count.add("col2im", (h, wd, c, kh, kw, stride, kp, gate is not None))
    return dx


def maxpool_fwd(x: torch.Tensor, *, count: LaunchCount):
    """The 3x3 stride-2 max pool (padding 1) of x (H, W, C) bf16, C % 8 ==
    0: the bf16 output and the int8 window index of each maximum, both
    (ceil(H/2), ceil(W/2), C)."""
    h, wd, c = x.shape
    _require(x, "x", torch.bfloat16, (h, wd, c))
    if c % 8:
        raise ValueError(f"max pool channels must be a multiple of 8, got {c}")
    ho, wo = strided_hw(h, wd, 2)
    y = torch.empty((ho, wo, c), dtype=torch.bfloat16, device=x.device)
    idx = torch.empty((ho, wo, c), dtype=torch.int8, device=x.device)
    lib = library()
    err = lib.st_maxpool_fwd(_ptr(x), _ptr(y), _ptr(idx), h, wd, c, ho, wo, _stream())
    _check_launch(lib, err, "maxpool_fwd")
    count.add("maxpool_fwd", (h, wd, c))
    return y, idx


def maxpool_bwd(dy: Optional[torch.Tensor], idx: torch.Tensor, hw: Tuple[int, int], *,
                count: LaunchCount, add: Optional[torch.Tensor] = None,
                gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (H, W, C) bf16 cotangent of the max pool's input: each pixel's
    share of ``dy`` (the pool's (Ho, Wo, C) bf16 cotangent; None reads as
    zero) by ``idx``, ``+ add`` (H, W, C) bf16, zero where ``gate`` (H, W,
    C) bf16 is <= 0."""
    h, wd = hw
    ho, wo, c = idx.shape
    _require(idx, "idx", torch.int8, strided_hw(h, wd, 2) + (c,))
    _opt(dy, "dy", torch.bfloat16, (ho, wo, c))
    _opt(add, "add", torch.bfloat16, (h, wd, c))
    _opt(gate, "gate", torch.bfloat16, (h, wd, c))
    dx = torch.empty((h, wd, c), dtype=torch.bfloat16, device=idx.device)
    lib = library()
    err = lib.st_maxpool_bwd(_ptr(dy), _ptr(idx), _ptr(add), _ptr(gate), _ptr(dx), h, wd, c, ho,
                             wo, _stream())
    _check_launch(lib, err, "maxpool_bwd")
    count.add("maxpool_bwd", (h, wd, c, dy is not None, add is not None, gate is not None))
    return dx


def relu_gate(dy: torch.Tensor, gate: torch.Tensor, *, count: LaunchCount) -> torch.Tensor:
    """``where(gate > 0, dy, 0)`` of two equally shaped bf16 tensors whose
    element count is a multiple of 8."""
    _require(dy, "dy", torch.bfloat16, tuple(gate.shape))
    _require(gate, "gate", torch.bfloat16, tuple(gate.shape))
    if dy.numel() % 8:
        raise ValueError(f"relu_gate takes a multiple of 8 elements, got {dy.numel()}")
    out = torch.empty_like(dy)
    lib = library()
    _check_launch(lib, lib.st_relu_gate(_ptr(dy), _ptr(gate), _ptr(out), dy.numel(), _stream()),
                  "relu_gate")
    count.add("relu_gate", (dy.numel(),))
    return out
