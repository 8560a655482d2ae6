"""Edge-case checks of the tensor-core kernels against plain PyTorch, on the card.

The launchers of ``csrc/conv3x3.cu`` and ``csrc/gram.cu`` (``_launch.
conv3x3_fwd``, ``conv3x3_bwd_data``, ``gram``, ``gram_fs``) are called
directly, one option at a time, at sizes that are ragged against every tile
(10x6, 26x12, 62x90, 128x136), with the odd channel counts of conv1_1
(K = 3, N = 3), and Grams from 60 to 262144 rows with and without a column
window. Each case runs the kernel in bf16, the same arithmetic in plain
PyTorch in bf16, and in fp32 on the same bf16-valued inputs (TF32 off); the
caller holds the errors to ``tolerances.within``. A case also launches its
kernel a second time and reports whether the outputs are bit-equal.

``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run the same lists. Needs
a CUDA device; nothing here runs on the CPU.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.ops.kernels.tolerances import TOL_ACT, TOL_GRAM

SIZES = ((10, 6), (26, 12), (62, 90), (128, 136))
FWD_CHANNELS = ((3, 64), (64, 64), (128, 256), (512, 512))
BWD_CHANNELS = ((64, 3), (64, 64), (128, 256), (512, 512))
#: backward-data options, one or two at a time
BWD_MODES = ("bare", "unpool", "in_mask", "unpool_in_mask", "pre_add", "pre_add_no_dy",
             "pre_gate", "pre_add_pre_gate_unpool", "add_gate")
GRAM_ROWS = ((60, 6, 1, 4), (4096, 64, 8, 56), (65536, 256, 8, 248), (262144, 512, 8, 504))
GRAM_CHANNELS = (64, 128, 256, 512)


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


def gram_cases():
    return [f"{kind}-{m}x{c}-{'window' if win else 'all'}"
            for kind in ("gram", "fs32", "fs16", "fs16gated") for (m, _, _, _) in GRAM_ROWS
            for c in GRAM_CHANNELS for win in (False, True)]


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


def run_conv_fwd(name: str, dev) -> dict:
    """y, mask and pool of one forward case: errors and the run-to-run check."""
    _, size, chans = name.split("-")
    h, w = (int(v) for v in size.split("x"))
    k, n = (int(v) for v in chans.split("to"))
    gen, bf = _gen(name, dev), torch.bfloat16
    x = torch.randn(h, w, k, generator=gen, device=dev).to(bf)
    wt = (torch.randn(3, 3, k, n, generator=gen, device=dev) * (2.0 / (9 * k)) ** 0.5).to(bf)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(bf)
    count = LaunchCount()
    outs = [_launch.conv3x3_fwd(x, wt, b, y=True, mask=True, pool=True, count=count)
            for _ in range(2)]
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


def run_conv_bwd(name: str, dev) -> dict:
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
                                     add=add, gate=gate) for _ in range(2)]

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
    (fs16) or ReLU-gated in bf16 (fs16gated), over all rows or a column window."""
    kind, shape, which = name.split("-")
    m, c = (int(v) for v in shape.split("x"))
    cols = next((wc, lo, hi) for (rows, wc, lo, hi) in GRAM_ROWS if rows == m) if which == "window" else None
    gen, bf = _gen(name, dev), torch.bfloat16
    f = torch.randn(m, c, generator=gen, device=dev).to(bf)
    owned = f
    if cols is not None:
        col = torch.arange(m, device=dev) % cols[0]
        owned = f * ((col >= cols[1]) & (col < cols[2])).to(bf)[:, None]
    count = LaunchCount()
    if kind == "gram":
        outs = [_launch.gram(f, count=count, cols=cols) for _ in range(2)]
        f32 = owned.float()
        errors = [_entry("gram", outs[0], (owned.T @ owned).float(), f32.T @ f32, TOL_GRAM)]
    else:
        s = (torch.randn(c, c, generator=gen, device=dev) / c ** 0.5).to(bf)
        gated, half = kind == "fs16gated", kind != "fs32"
        outs = [_launch.gram_fs(f, s, count=count, relu_gate=gated, out_bf16=half, cols=cols)
                for _ in range(2)]
        ref, plain = owned.float() @ s.float(), (owned @ s).float()
        if gated:
            zero = torch.zeros_like(ref)
            ref, plain = torch.where(f > 0, ref, zero), torch.where(f > 0, plain, zero)
        errors = [_entry(kind, outs[0], plain, ref, TOL_ACT if half else TOL_GRAM)]
    return {"case": name, "errors": errors, "run_to_run_equal": torch.equal(outs[0], outs[1]),
            "launches": count.n}


def run_case(name: str, dev) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if name.startswith("fwd-"):
        return run_conv_fwd(name, dev)
    if name.startswith("bwd-"):
        return run_conv_bwd(name, dev)
    return run_gram(name, dev)


def all_cases():
    return conv_fwd_cases() + conv_bwd_cases() + gram_cases()


def tile_table_matches(lib) -> bool:
    """Whether the wrapper's tile table (``_launch.CONV_TILES``,
    ``conv_tile_smem``) is the built library's."""
    import ctypes

    for tile, (th, tw, bn, warps, _) in _launch.CONV_TILES.items():
        got = (ctypes.c_int * 5)()
        if lib.st_conv3x3_tile_info(tile, got):
            return False
        if list(got) != [th, tw, bn, 32 * warps, _launch.conv_tile_smem(tile)]:
            return False
    return True
