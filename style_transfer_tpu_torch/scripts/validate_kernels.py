"""Validation of the port's kernels at print sizes, one kernel at a time.

Twin of the JAX package's ``scripts/validate_kernels.py``. For each fused
segment (block 1, block 2, the block-3/4 pairs, the pairs of singles, the
W-sliced pairs of singles, the conv5_1 conv+Gram and ``gram_tail``) at each
requested image size, at that size's natural block shape, it runs the
port's kernel wrapper forward and backward, compares its outputs and its
input gradient with the kernel's plain version run in fp32 on the same
bf16-valued inputs, weights and cotangents, and times the kernel, the plain
version (in bf16) and the library yardstick: ``F.conv2d`` forward and
backward-data of the bare conv chain in bf16, channels-last (the one that
``chip_smoke.py``'s kernel phase times).

Usage (GPU):  python -m style_transfer_tpu_torch.scripts.validate_kernels --sizes 1024 4096
Smoke (CPU):  python -m style_transfer_tpu_torch.scripts.validate_kernels --device cpu \\
                  --sizes 64 --repeats 0

Prints a table to stderr and one JSON line per (kernel, size) to stdout:
``kernel``, ``size``, ``shape``, ``route`` (``"cuda"``: the CUDA kernels;
``"plain"``: ``--device cpu``, where every wrapper runs its plain version,
so the record checks no kernel), ``value_rel`` (the largest relative
Frobenius error of an output), ``grad_rel`` (the input gradient's),
``errors`` (each output's error, the plain bf16 version's and the limit),
``ok``, and ``kernel_ms``, ``plain_ms``, ``library_ms`` (median of
``--repeats`` forward+backward calls; CUDA events on the card). The limits
are those of ``ops/kernels/tolerances.py`` (no ``--rtol`` here: one module
holds them): an activation within ``TOL_ACT``, a Gram within ``TOL_GRAM``,
the input gradient within ``TOL_DX``, each also within
``tolerances.within`` of the plain bf16 version's own error. Exit code 0
iff every case passed; without CUDA and without ``--device cpu``, 2.

Inputs are made chain-style, ``relu(x + 0.1)`` of a seeded normal tensor,
as the JAX harness feeds its kernels (there that choice decides the
operand's layout under Mosaic; here it only makes the input an
activation); the gradient is taken with respect to ``x``. ``--height``
overrides the image height (each block still halves both extents). A pooled
block whose input has an odd extent is reported skipped (``ok``): the
chain hands such a shape to the plain path (``networks.VGG.plan``), so no kernel
ever sees it. ``w2``-``w4`` run the W-sliced forms with two slices: the port
has no slice-count rule (``conv_single.py``), and two slices exercise the
stitching. The JAX harness's ``--force-gated`` and ``--param-input`` probe
Mosaic's scoped-VMEM envelope and the parameter layouts of a TPU compile,
which the port does not have; it has neither flag.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

BLOCKS = ("b1", "b2", "b3", "b4", "cg", "s2", "s3", "s4", "gt", "w2", "w3", "w4")
DEFAULT_BLOCKS = ("b1", "b2", "b3", "b4", "cg", "s2", "s3", "s4", "gt")

# block -> (record name, shrink, cin, cmid, pool, gram, form, weight scale)
# (the JAX harness's names, shapes and weight scales)
CASES = {
    "b1": ("block1_packed", 1, 3, 64, True, True, "block1", (0.2, 0.1)),
    "b2": ("block2", 2, 64, 128, True, True, "block2", (0.05, 0.05)),
    "s2": ("singles(b2)", 2, 64, 128, True, True, "singles", (0.05, 0.05)),
    "w2": ("wide(b2)", 2, 64, 128, True, True, "wide", (0.05, 0.05)),
    "b3": ("pair_gram(b3)", 4, 128, 256, False, True, "pair", (0.05, 0.05)),
    "s3": ("singles(b3f)", 4, 128, 256, False, True, "singles", (0.05, 0.05)),
    "w3": ("wide(b3f)", 4, 128, 256, False, True, "wide", (0.05, 0.05)),
    "b4": ("pair_pool(b4)", 8, 512, 512, True, False, "pair", (0.02, 0.02)),
    "s4": ("singles(b4t)", 8, 512, 512, True, False, "singles", (0.02, 0.02)),
    "w4": ("wide(b4t)", 8, 512, 512, True, False, "wide", (0.02, 0.02)),
    "cg": ("conv_gram(5_1)", 16, 512, 512, False, True, "conv_gram", (0.02,)),
    "gt": ("gram_tail(5_1)", 16, 512, 512, False, True, "gram_tail", (0.02,)),
}
#: The W-sliced forms' slice count (module docstring).
WIDE_SLICES = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _functions(block: str):
    """``(kernel wrapper, plain version)`` of a block, both
    ``f(x, *weights)``."""
    from style_transfer_tpu_torch.ops.kernels import block1 as B1
    from style_transfer_tpu_torch.ops.kernels import block2 as B2
    from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
    from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
    from style_transfer_tpu_torch.ops.kernels import conv_single as CS

    _, _, _, _, pool, gram, form, _ = CASES[block]

    def pair_plain(x, k1, b1, k2, b2):
        return CP.conv_pair_plain(x, k1, b1, k2, b2, pool=pool, gram=gram)

    kernels = {
        "block1": B1.block1_packed,
        "block2": B2.block2_fused,
        "pair": CP.make_conv_pair(pool=pool, gram=gram),
        "singles": CS.make_pair_of_singles(pool=pool, gram=gram),
        "wide": CS.make_wide_pair_of_singles(pool=pool, gram=gram, slices=WIDE_SLICES),
        "conv_gram": CG.conv_gram,
        "gram_tail": CS.gram_tail,
    }
    if form == "conv_gram":
        return kernels[form], CG.conv_gram_plain
    if form == "gram_tail":
        return kernels[form], lambda x, k, b: CS.conv_single_plain(x, k, b, pool=False,
                                                                   gram=True)[1]
    return kernels[form], pair_plain


def _median_ms(torch, fn, repeats: int, device) -> float:
    """Median milliseconds of ``repeats`` calls of ``fn`` after one warm-up
    call: CUDA events around each call on the card, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _conv_library(torch, h, w, chain, device):
    """Forward and backward-data of the bare conv chain through ``F.conv2d``
    (bf16, channels-last): the library yardstick."""
    import torch.nn.functional as F

    bf16, cl = torch.bfloat16, torch.channels_last
    x = torch.randn(1, chain[0][0], h, w, device=device, dtype=bf16).contiguous(memory_format=cl)
    wts = [torch.randn(cout, cin, 3, 3, device=device, dtype=bf16).contiguous(memory_format=cl)
           for cin, cout in chain]
    gy = torch.randn(1, chain[-1][1], h, w, device=device, dtype=bf16).contiguous(memory_format=cl)

    def call():
        xr = x.detach().requires_grad_(True)
        y = xr
        for wt in wts:
            y = F.conv2d(y, wt, padding=1)
        torch.autograd.grad(y, xr, grad_outputs=gy)

    return call


def run_case(torch, block: str, size: int, height: int, repeats: int, device, gen) -> dict:
    """One (block, size) record; see the module docstring."""
    from style_transfer_tpu_torch.ops.kernels import tolerances as T

    name, shrink, cin, cmid, pool, gram, form, scales = CASES[block]
    h, w = height // shrink, size // shrink
    rec = {"kernel": name, "size": size, "shape": [1, h, w, cin],
           "route": "cuda" if device.type == "cuda" else "plain"}
    if pool and (h % 2 or w % 2):
        rec.update(ok=True, skipped="odd extent under a pool: the chain hands this shape to "
                                    "the plain path (networks.VGG.plan)")
        return rec
    bf16, f32 = torch.bfloat16, torch.float32

    def bf(t):  # bf16 values in fp32 storage
        return t.to(bf16).to(f32)

    x = bf(0.3 * torch.randn(1, h, w, cin, generator=gen, device=device))
    weights = []
    for i, s in enumerate(scales):
        ci, co = (cin, cmid) if i == 0 else (cmid, cmid)
        weights += [bf(s * torch.randn(3, 3, ci, co, generator=gen, device=device)),
                    bf(0.1 * torch.randn(co, generator=gen, device=device))]
    out_shape = [1, h // 2, w // 2, cmid] if pool else [1, h, w, cmid]
    cts = [] if form in ("conv_gram", "gram_tail") else [
        torch.randn(out_shape, generator=gen, device=device)]
    if gram:
        cts.append(torch.randn(cmid, cmid, generator=gen, device=device) * (h * w / cmid))
    tols = [T.TOL_GRAM if c.dim() == 2 else T.TOL_ACT for c in cts] + [T.TOL_DX]
    kernel, plain = _functions(block)

    def run(fn, dtype):
        xr = x.to(dtype).requires_grad_(True)
        xin = torch.relu(xr + 0.1)  # chain-style input
        if dtype == f32:  # the same bf16 values, the gradient passed straight through
            xin = xin + (bf(xin) - xin).detach()
        outs = fn(xin, *[t.to(dtype) for t in weights])
        outs = outs if isinstance(outs, tuple) else (outs,)
        (dx,) = torch.autograd.grad(outs, xr, grad_outputs=[c.to(o.dtype)
                                                           for c, o in zip(cts, outs)])
        return [o.detach() for o in outs] + [dx]

    def rel(a, b):
        a, b = a.to(f32), b.to(f32)
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    ref = run(plain, f32)
    got = run(kernel, bf16)
    plain16 = run(plain, bf16)
    errors = [{"rel": rel(k, r), "plain_bf16_rel": rel(p, r), "tol": tol}
              for k, r, p, tol in zip(got, ref, plain16, tols)]
    del ref, got, plain16
    rec["value_rel"] = max(e["rel"] for e in errors[:-1])
    rec["grad_rel"] = errors[-1]["rel"]
    rec["errors"] = errors
    rec["ok"] = all(T.within(e["rel"], e["plain_bf16_rel"], e["tol"]) for e in errors)
    if repeats:
        chain = [(cin, cmid)] + [(cmid, cmid)] * (len(scales) - 1)
        rec["kernel_ms"] = _median_ms(torch, lambda: run(kernel, bf16), repeats, device)
        rec["plain_ms"] = _median_ms(torch, lambda: run(plain, bf16), repeats, device)
        rec["library_ms"] = _median_ms(torch, _conv_library(torch, h, w, chain, device),
                                       repeats, device)
    else:
        rec["kernel_ms"] = rec["plain_ms"] = rec["library_ms"] = None
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[1024],
                   help="image long sides; each kernel runs at its natural block shape for "
                        "that size")
    p.add_argument("--blocks", nargs="+", default=list(DEFAULT_BLOCKS), choices=BLOCKS)
    p.add_argument("--height", type=int, default=None,
                   help="override the image height (the width keeps the size-derived natural "
                        "value; each kernel still halves both per block)")
    p.add_argument("--repeats", type=int, default=20,
                   help="timing repeats (the correctness check always runs)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the NVIDIA GPU (default) or the CPU, where every wrapper runs its "
                        "plain version (records say route plain)")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("validate_kernels: CUDA is not available; pass --device cpu to check the plain "
            "versions on the CPU")
        return 2
    device = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    log(f"device={torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    all_ok = True
    for size in args.sizes:
        height = args.height or size
        if min(size, height) < 16:
            log(f"size {size}x{height}: skipping (conv5_1's block needs 16 px)")
            continue
        log(f"== image size {size}" + (f" (height {height})" if args.height else "") + " ==")
        for block in args.blocks:
            rec = run_case(torch, block, size, height, args.repeats, device, gen)
            all_ok &= rec["ok"]
            if "skipped" in rec:
                log(f"  {rec['kernel']}@{size}: skipped ({rec['skipped']})")
            else:
                times = ("" if rec["kernel_ms"] is None else
                         f"  kernel {rec['kernel_ms']:.3f} ms, plain {rec['plain_ms']:.3f}, "
                         f"library {rec['library_ms']:.3f}")
                log(f"  {rec['kernel']}@{size}: ok={rec['ok']} value_rel={rec['value_rel']:.2e} "
                    f"grad_rel={rec['grad_rel']:.2e}{times}")
            print(json.dumps(rec), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    log("ALL OK" if all_ok else "FAILURES: see the JSON records above")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
