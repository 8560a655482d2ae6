"""Edge-case checks of the tensor-core kernels against plain PyTorch, on the card.

The launchers of ``csrc/conv3x3.cu`` and ``csrc/gram.cu`` (``_launch.
conv3x3_fwd``, ``conv3x3_bwd_data``, ``gram``, ``gram_fs``) are called
directly, one option at a time, at sizes that are ragged against every tile
(10x6, 26x12, 62x90, 128x136), with the odd channel counts of conv1_1
(K = 3, N = 3), and Grams from 60 to 262144 rows at 64-512 channels and
up to 16384 rows at 1024 and 2048, over all rows, a column window and a row
span. Each conv case runs once on the tile the chooser gives it (at
these ragged sizes always a small ``mma.sync`` tile) and once more on every
tile configuration that serves its output channels, forced through the
launcher's ``tile`` argument (``tile<i>:<case>``), so the warpgroup tile
meets the ragged edges, K = 3 and N = 3 too. Each case runs the kernel in
bf16, the same arithmetic in plain PyTorch in bf16, and in fp32 on the same
bf16-valued inputs (TF32 off); the caller holds the errors to
``tolerances.within``. A case also launches its kernel a second time and
reports whether the outputs are bit-equal.

The one-pass block-1 kernels of ``csrc/block1.cu`` run through their
wrappers (``block1.block1_full``, ``block1_tail``) under autograd at the same
ragged sizes (10x6 is smaller than one 16x16 tile) and at 210x300, whose 266
tiles leave the last persistent block a short run, with only the pooled
cotangent, only the Gram's, and both; and ``block1_col2im`` against its plain
version, bit for bit.

The loss kernels of ``csrc/epilogue.cu`` and ``csrc/tv.cu`` run through
their wrappers (``epilogue.content_loss``, ``tv_loss``) under autograd: the
SSE at element counts around the vector width (1, 7, 8,
9), around one block's share (2047, 2048, 2049), at the Gram sizes (64^2,
512^2), at conv4_2's 8388608 and at 8388611, in bf16 and fp32; TV from a
single pixel and single rows and columns (scalar columns) to 512x8192 (the
widest index); each with the cotangents 1, 0.7 and 0. The loss is held to
float64, the gradient must have the bits of its plain backward, and two
launches the same bits.

``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run the same lists. Needs
a CUDA device; nothing here runs on the CPU.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.ops.kernels.tolerances import (
    TOL_ACT, TOL_DX, TOL_GRAM, TOL_LOSS, TOL_TV,
)

C1 = 64  # channels of VGG block 1

SIZES = ((10, 6), (26, 12), (62, 90), (128, 136))
FWD_CHANNELS = ((3, 64), (64, 64), (128, 256), (512, 512))
BWD_CHANNELS = ((64, 3), (64, 64), (128, 256), (512, 512))
#: backward-data options, one or two at a time
BWD_MODES = ("bare", "unpool", "in_mask", "unpool_in_mask", "pre_add", "pre_add_no_dy",
             "pre_gate", "pre_add_pre_gate_unpool", "add_gate")
#: Gram rows M, a column window (W, clo, chi) and a row span (lo, hi) of
#: image rows W wide: M = 60, 5000 and 131080 are ragged against the 64-row
#: steps and 128-row tiles of ``csrc/gram.cu``; F^T F takes 64-wide tiles
#: while F holds at most 2^21 elements and, beyond, its rows in chunks at
#: 256-1024 channels (``_launch.gram_config``); F S 64-wide tiles at 128
#: channels and at few rows (``_launch.gram_fs_width``)
GRAM_ROWS = ((60, 6, 1, 4, 1, 9), (4096, 64, 8, 56, 3, 61), (5000, 40, 3, 37, 7, 118),
             (65536, 256, 8, 248, 100, 250), (131080, 40, 3, 37, 7, 3270),
             (262144, 512, 8, 504, 5, 500))
GRAM_CHANNELS = (64, 128, 256, 512)
#: ResNet-50's widths, at fewer rows (its 2048^2 cell's are 16384 and 4096)
GRAM_WIDE_ROWS = ((60, 6, 1, 4, 1, 9), (5000, 40, 3, 37, 7, 118), (16384, 128, 3, 125, 10, 120))
GRAM_WIDE_CHANNELS = (1024, 2048)
GRAM_SPANS = ("all", "window", "span")
BLOCK1_SIZES = SIZES + ((210, 300),)
BLOCK1_COTANGENTS = ("pool", "gram", "both")
SSE_COUNTS = (1, 7, 8, 9, 2047, 2048, 2049, 64 * 64, 512 * 512, 8388608, 8388611)
TV_SIZES = ((1, 1), (1, 9), (9, 1), (2, 2), (5, 7), (63, 65), (362, 362), (512, 8192))
LOSS_COTANGENTS = (1.0, 0.7, 0.0)


def conv_fwd_cases():
    return [f"fwd-{h}x{w}-{k}to{n}" for (h, w), (k, n) in itertools.product(SIZES, FWD_CHANNELS)]


def conv_bwd_cases():
    # every mode at the two small sizes and the 64-channel shapes; the large
    # sizes and widths with the modes that change the staging path
    small = [f"bwd-{m}-{h}x{w}-{k}to{n}" for m in BWD_MODES for (h, w) in SIZES[:2]
             for (k, n) in BWD_CHANNELS[:2]]
    large = [f"bwd-{m}-{h}x{w}-{k}to{n}" for m in ("bare", "unpool_in_mask", "pre_add_pre_gate_unpool",
                                                   "add_gate")
             for (h, w) in SIZES[2:] for (k, n) in BWD_CHANNELS]
    wide = [f"bwd-{m}-{h}x{w}-{k}to{n}" for m in ("bare", "pre_add_no_dy") for (h, w) in SIZES[:2]
            for (k, n) in BWD_CHANNELS[2:]]
    return small + large + wide


def forced_conv_cases():
    """Every conv case again on every tile configuration that serves its
    output channels (the n8 tile serves up to 8), forced past the chooser,
    which sends these ragged sizes to the small tiles: ``tile<i>:<case>``."""
    return [f"tile{t}:{c}" for t in sorted(_launch.CONV_TILES)
            for c in conv_fwd_cases() + conv_bwd_cases()
            if _launch.CONV_TILES[t][2] > 8 or int(c.rsplit("to", 1)[1]) <= 8]


def gram_cases():
    shapes = [(r[0], c) for r in GRAM_ROWS for c in GRAM_CHANNELS]
    shapes += [(r[0], c) for r in GRAM_WIDE_ROWS for c in GRAM_WIDE_CHANNELS]
    return [f"{kind}-{m}x{c}-{which}" for kind in ("gram", "fs32", "fs16", "fs16gated")
            for (m, c) in shapes for which in GRAM_SPANS]


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _gen(name: str, dev):
    return torch.Generator(device=dev).manual_seed(sum(name.encode()))


def _conv(x, w):
    """SAME 3x3 correlation of (H, W, K) with (3, 3, K, N) taps, in x's dtype."""
    y = F.conv2d(x.permute(2, 0, 1)[None], w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    return y[0].permute(1, 2, 0)


def _pool(y):
    h, w, n = y.shape
    y = y.reshape(h // 2, 2, w // 2, 2, n)
    return ((y[:, 0, :, 0] + y[:, 0, :, 1]) + (y[:, 1, :, 0] + y[:, 1, :, 1])) * 0.25


def _entry(what, kernel, plain, ref, tol):
    return {"what": what, "rel": _rel(kernel, ref), "plain_bf16_rel": _rel(plain, ref), "tol": tol,
            "max_abs": float((kernel.float() - ref.float()).abs().max())}


def run_conv_fwd(name: str, dev, tile=None) -> dict:
    """y, mask and pool of one forward case: errors and the run-to-run check."""
    _, size, chans = name.split("-")
    h, w = (int(v) for v in size.split("x"))
    k, n = (int(v) for v in chans.split("to"))
    gen, bf = _gen(name, dev), torch.bfloat16
    x = torch.randn(h, w, k, generator=gen, device=dev).to(bf)
    wt = (torch.randn(3, 3, k, n, generator=gen, device=dev) * (2.0 / (9 * k)) ** 0.5).to(bf)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(bf)
    count = LaunchCount()
    outs = [_launch.conv3x3_fwd(x, wt, b, y=True, mask=True, pool=True, count=count,
                                tile=tile) for _ in range(2)]
    y, mask, pool = outs[0]
    pre32 = _conv(x.float(), wt.float()) + b.float()
    pre16 = _conv(x, wt) + b
    errors = [_entry("y", y, torch.relu(pre16), torch.relu(pre32), TOL_ACT),
              _entry("pool", pool, _pool(torch.relu(pre16).float()).to(bf),
                     _pool(torch.relu(pre32)), TOL_ACT)]
    # the mask may differ from the fp32 one only where the pre-activation is
    # within bf16 rounding of zero
    wrong = (mask != 0) != (pre32 > 0)
    mask_slip = float(pre32[wrong].abs().max()) if bool(wrong.any()) else 0.0
    same = all(torch.equal(a, c) for a, c in zip(outs[0], outs[1]))
    return {"case": name, "errors": errors, "mask_wrong": int(wrong.sum()),
            "mask_slip": mask_slip, "mask_slip_limit": 2e-2 * float(pre32.abs().max()),
            "run_to_run_equal": same, "launches": count.n}


def run_conv_bwd(name: str, dev, tile=None) -> dict:
    """One backward-data case: the prologue and epilogue options of its mode."""
    _, mode, size, chans = name.split("-")
    h, w = (int(v) for v in size.split("x"))
    k, n = (int(v) for v in chans.split("to"))
    gen, bf = _gen(name, dev), torch.bfloat16
    unpool = "unpool" in mode
    dy = None
    if mode != "pre_add_no_dy":
        dy = torch.randn((h // 2, w // 2, k) if unpool else (h, w, k), generator=gen, device=dev).to(bf)
    w_t = (torch.randn(3, 3, k, n, generator=gen, device=dev) * (2.0 / (9 * k)) ** 0.5).to(bf)
    in_mask = pre_add = pre_gate = add = gate = None
    if "in_mask" in mode:
        in_mask = (torch.rand(h, w, k, generator=gen, device=dev) > 0.4).to(torch.int8)
    if "pre_add" in mode:
        pre_add = torch.randn(h, w, k, generator=gen, device=dev)
    if "pre_gate" in mode:
        pre_gate = torch.randn(h, w, k, generator=gen, device=dev).to(bf)
    if mode == "add_gate":
        add = torch.randn(h, w, n, generator=gen, device=dev)
        gate = torch.randn(h, w, n, generator=gen, device=dev).to(bf)
    count = LaunchCount()
    outs = [_launch.conv3x3_bwd_data(dy, w_t, hw=(h, w), count=count, in_mask=in_mask,
                                     unpool=unpool, pre_add=pre_add, pre_gate=pre_gate,
                                     add=add, gate=gate, tile=tile) for _ in range(2)]

    def plain(dt):
        v = torch.zeros(h, w, k, device=dev, dtype=torch.float32)
        if dy is not None:
            v = dy.float()
            if unpool:
                v = v.repeat_interleave(2, 0).repeat_interleave(2, 1) * 0.25
        if in_mask is not None:
            v = v * (in_mask != 0)
        if pre_add is not None:
            v = v + pre_add
        if pre_gate is not None:
            v = torch.where(pre_gate > 0, v, torch.zeros_like(v))
        v = v.to(bf).to(dt)  # every staged value is a bf16 value
        out = _conv(v, w_t.to(dt)).float()
        if add is not None:
            out = out + add
        if gate is not None:
            out = torch.where(gate > 0, out, torch.zeros_like(out))
        return out.to(dt)

    return {"case": name, "errors": [_entry("out", outs[0], plain(bf), plain(torch.float32), TOL_ACT)],
            "run_to_run_equal": torch.equal(outs[0], outs[1]), "launches": count.n}


def run_gram(name: str, dev) -> dict:
    """One Gram case: ``F^T F`` (gram), ``F S`` in fp32 (fs32), in bf16
    (fs16) or ReLU-gated in bf16 (fs16gated), over all rows, a column window
    or a row span."""
    kind, shape, which = name.split("-")
    m, c = (int(v) for v in shape.split("x"))
    _, wc, clo, chi, lo, hi = next(r for r in GRAM_ROWS + GRAM_WIDE_ROWS if r[0] == m)
    cols = (wc, clo, chi) if which == "window" else None
    rows = (wc, lo, hi) if which == "span" else None
    gen, bf = _gen(name, dev), torch.bfloat16
    f = torch.randn(m, c, generator=gen, device=dev).to(bf)
    owned = f
    if cols is not None:
        col = torch.arange(m, device=dev) % wc
        owned = f * ((col >= clo) & (col < chi)).to(bf)[:, None]
    if rows is not None:
        row = torch.arange(m, device=dev) // wc
        owned = f * ((row >= lo) & (row < hi)).to(bf)[:, None]
    count = LaunchCount()
    if kind == "gram":
        outs = [_launch.gram(f, count=count, cols=cols, rows=rows) for _ in range(2)]
        f32 = owned.float()
        errors = [_entry("gram", outs[0], (owned.T @ owned).float(), f32.T @ f32, TOL_GRAM)]
    else:
        s = (torch.randn(c, c, generator=gen, device=dev) / c ** 0.5).to(bf)
        gated, half = kind == "fs16gated", kind != "fs32"
        outs = [_launch.gram_fs(f, s, count=count, relu_gate=gated, out_bf16=half, cols=cols,
                                rows=rows) for _ in range(2)]
        ref, plain = owned.float() @ s.float(), (owned @ s).float()
        if gated:
            zero = torch.zeros_like(ref)
            ref, plain = torch.where(f > 0, ref, zero), torch.where(f > 0, plain, zero)
        errors = [_entry(kind, outs[0], plain, ref, TOL_ACT if half else TOL_GRAM)]
    return {"case": name, "errors": errors, "run_to_run_equal": torch.equal(outs[0], outs[1]),
            "launches": count.n}


def block1_cases():
    cases = [f"block1{kind}-{ct}-{h}x{w}" for kind in ("full", "tail") for ct in BLOCK1_COTANGENTS
             for (h, w) in BLOCK1_SIZES]
    return cases + [f"col2im-{h}x{w}" for (h, w) in BLOCK1_SIZES]


def run_block1(name: str, dev) -> dict:
    """``block1_full`` or ``block1_tail`` with the named cotangents: pool1,
    the Gram and the input gradient, two launches bit for bit."""
    from style_transfer_tpu_torch.ops.kernels import block1 as B1

    kind, which, size = name.split("-")
    h, w = (int(v) for v in size.split("x"))
    full = kind == "block1full"
    gen, bf = _gen(name, dev), torch.bfloat16
    vals = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(bf).float()  # noqa: E731
    x = vals(1, h, w, 3) if full else torch.relu(vals(1, h, w, C1))
    ws = []
    for cin in ((3, C1) if full else (C1,)):
        ws += [vals(3, 3, cin, C1) * (2.0 / (9 * cin)) ** 0.5, 0.1 * vals(C1)]
    ws = [t.to(bf).float() for t in ws]
    cts = {"pool": vals(1, h // 2, w // 2, C1), "gram": vals(C1, C1) * (h * w / C1)}
    used = ("pool", "gram") if which == "both" else (which,)
    kernel, plain = (B1.block1_full, B1.block1_plain) if full else (B1.block1_tail, B1.block1_tail_plain)
    count = B1.full_launches if full else B1.tail_launches

    def run(fn, dt):
        xr = x.to(dt).requires_grad_(True)
        outs = dict(zip(("pool", "gram"), fn(xr, *ws)))
        (dx,) = torch.autograd.grad([outs[k] for k in used], xr,
                                    grad_outputs=[cts[k].to(outs[k].dtype) for k in used])
        return [outs["pool"].detach(), outs["gram"].detach(), dx]

    before = count.n
    first = run(kernel, bf)
    launches = count.n - before  # one forward and one backward
    second = run(kernel, bf)
    p16, ref = run(plain, bf), run(plain, torch.float32)
    errors = [_entry(what, k, p, r, tol) for what, k, p, r, tol in
              zip(("pool", "gram", "dx"), first, p16, ref, (TOL_ACT, TOL_GRAM, TOL_DX))]
    return {"case": name, "errors": errors, "launches": launches,
            "run_to_run_equal": all(torch.equal(a, b) for a, b in zip(first, second))}


def run_col2im(name: str, dev) -> dict:
    """``block1_col2im`` against ``block1._col2im3``: the same fp32 sums in
    the same order, so the same bits."""
    from style_transfer_tpu_torch.ops.kernels import block1 as B1

    h, w = (int(v) for v in name.split("-")[1].split("x"))
    dpt = torch.randn(9, h, w, 3, generator=_gen(name, dev), device=dev).to(torch.bfloat16)
    outs = [_launch.block1_col2im(dpt) for _ in range(2)]
    plain = B1._col2im3(dpt)
    exact = torch.equal(outs[0], plain.to(torch.bfloat16))
    return {"case": name, "errors": [_entry("dx", outs[0], plain.to(torch.bfloat16), plain, TOL_ACT)],
            "run_to_run_equal": torch.equal(outs[0], outs[1]) and exact, "launches": 2}


def loss_cases():
    sse = [f"sse-{dt}-{n}-ct{ct}" for dt in ("bf16", "fp32") for n in SSE_COUNTS
           for ct in LOSS_COTANGENTS]
    return sse + [f"tv-{h}x{w}-ct{ct}" for (h, w) in TV_SIZES for ct in LOSS_COTANGENTS]


def run_loss(name: str, dev) -> dict:
    """One loss case, called twice: the loss against float64, the gradient
    against the plain backward (bit for bit) and against float64, and
    whether both calls gave the same bits."""
    from style_transfer_tpu_torch.ops.kernels import epilogue as EP

    kind, *spec, ct = name.split("-")
    ct = torch.tensor(float(ct[2:]), device=dev)
    gen = _gen(name, dev)
    if kind == "sse":
        dtype = torch.bfloat16 if spec[0] == "bf16" else torch.float32
        x = torch.rand(int(spec[1]), generator=gen, device=dev).to(dtype)
        t = torch.rand(int(spec[1]), generator=gen, device=dev).to(dtype)
        d64 = x.double() - t.double()
        ref, ref_grad = (d64 * d64).mean(), d64 * (2.0 * ct.double() / x.numel())
        fn, plain, count = (lambda v: EP.content_loss(v, t), lambda v: EP.content_loss_plain(v, t),
                            EP.content_launches)
        plain_grad = EP.sse_backward_plain(ct, x, t)
        tols = (TOL_LOSS, TOL_ACT if dtype == torch.bfloat16 else TOL_LOSS)
    else:
        h, w = (int(v) for v in spec[0].split("x"))
        x = torch.rand(1, h, w, 3, generator=gen, device=dev)
        x64 = x.double().requires_grad_(True)
        ref = (((x64[:, 1:] - x64[:, :-1]) ** 2).sum()
               + ((x64[:, :, 1:] - x64[:, :, :-1]) ** 2).sum()) / x64.numel()
        (ref_grad,) = torch.autograd.grad(ref, x64, ct.double())
        ref = ref.detach()
        fn, plain, count = EP.tv_loss, EP.tv_loss_plain, EP.launches
        plain_grad = EP.tv_backward_plain(x, ct)
        tols = (TOL_TV, TOL_TV)

    def call(f):
        xr = x.detach().requires_grad_(True)
        loss = f(xr)
        (g,) = torch.autograd.grad(loss, xr, ct)
        return loss.detach(), g

    before = count.n
    loss, grad = call(fn)
    launches = count.n - before  # one forward and one backward
    again = call(fn)
    p_loss, _ = call(plain)
    same = torch.equal(again[0], loss) and torch.equal(again[1], grad)
    exact = torch.equal(grad, plain_grad)

    def entry(what, kernel, plain_out, ref_out, tol):  # as _entry, compared in float64
        rel = lambda a: float((a.double() - ref_out).norm() / ref_out.norm().clamp_min(1e-30))  # noqa: E731
        return {"what": what, "rel": rel(kernel), "plain_bf16_rel": rel(plain_out), "tol": tol,
                "max_abs": float((kernel.double() - ref_out).abs().max())}

    errors = [entry("loss", loss, p_loss, ref, tols[0])]
    if float(ct) != 0.0:  # a zero gradient has no relative error
        errors.append(entry("dx", grad, plain_grad, ref_grad, tols[1]))
    return {"case": name, "errors": errors, "run_to_run_equal": same, "backward_exact": exact,
            "launches": launches}


def run_case(name: str, dev) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if name.startswith(("sse-", "tv-")):
        return run_loss(name, dev)
    tile = None
    if name.startswith("tile"):
        tile, name = name.split(":")
        tile = int(tile[4:])
    if name.startswith("fwd-"):
        return run_conv_fwd(name, dev, tile)
    if name.startswith("bwd-"):
        return run_conv_bwd(name, dev, tile)
    if name.startswith("block1"):
        return run_block1(name, dev)
    if name.startswith("col2im-"):
        return run_col2im(name, dev)
    return run_gram(name, dev)


def all_cases():
    return (conv_fwd_cases() + conv_bwd_cases() + forced_conv_cases() + gram_cases()
            + block1_cases() + loss_cases())


def gram_model_matches(lib) -> bool:
    """Whether the wrapper's model of ``csrc/gram.cu`` (rows a step of F^T
    F, rows of an F S tile) is the built library's."""
    import ctypes

    got = (ctypes.c_int * 2)()
    return not lib.st_gram_info(got) and list(got) == [_launch.GRAM_ROW_STEP, _launch.GRAM_FS_ROWS]


def loss_model_matches(lib) -> bool:
    """Whether the wrapper's model of the loss kernels' grids (threads per
    block of ``csrc/epilogue.cu`` and ``csrc/tv.cu``, loads in flight per
    thread, rows per block) is the built library's."""
    import ctypes

    sse, tv = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    if lib.st_sse_info(sse) or lib.st_tv_info(tv):
        return False
    return (list(sse) == [_launch.SSE_THREADS, _launch.SSE_UNROLL]
            and list(tv) == [_launch.TV_THREADS, _launch.TV_ROWS])


def block1_model_matches(lib) -> bool:
    """Whether the wrapper's model of ``csrc/block1.cu`` (tile, threads,
    blocks, shared memory of its four kernels, Gram partials per image size)
    is the built library's."""
    import ctypes

    got = (ctypes.c_int * 8)()
    if lib.st_block1_info(got):
        return False
    want = [*_launch.BLOCK1_TILE, _launch.BLOCK1_THREADS, _launch.SM_COUNT,
            _launch.block1_smem(False, False), _launch.block1_smem(True, False),
            _launch.block1_smem(False, True), _launch.block1_smem(True, True)]
    sizes = BLOCK1_SIZES + ((1024, 1024), (512, 8192), (2048, 2048))
    return list(got) == want and all(
        lib.st_block1_partials(h, w) == _launch.block1_blocks(h, w) for h, w in sizes)


def tile_table_matches(lib) -> bool:
    """Whether the wrapper's tile table (``_launch.CONV_TILES``,
    ``conv_tile_smem``, ``CONV_WGMMA_TILE``) is the built library's."""
    import ctypes

    for tile, (th, tw, bn, warps, _, minb) in _launch.CONV_TILES.items():
        got = (ctypes.c_int * 7)()
        if lib.st_conv3x3_tile_info(tile, got):
            return False
        if list(got) != [th, tw, bn, 32 * warps, _launch.conv_tile_smem(tile), minb,
                         int(tile == _launch.CONV_WGMMA_TILE)]:
            return False
    return True
