"""ResNet-50's kernels (``csrc/conv1x1.cu``, ``csrc/im2col.cu``) against
their plain fp32 forms, on the card.

Every test carries the ``cuda`` marker and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_resnet_cuda.py -q

The kernel runs in bf16 against the plain form (``ops/kernels/resnet.py``,
``*_plain``) run in fp32 on the same bf16-valued inputs, under the limits of
``ops/kernels/tolerances.py``: the relative Frobenius error of an
activation within ``TOL_ACT``, of an input gradient within ``TOL_DX``; the
copies (im2col, the max pool's values and window indices, the gate) exact.
Shapes: those of the 2048^2 cell (the stem's 1024^2 columns, each stage's
1x1s, stride-2 projections and im2col'd 3x3s) and edges (odd extents,
ragged tiles, the stem's 147 columns padded to 152, 2048 channels).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from style_transfer_tpu_torch.models import resnet as R
from style_transfer_tpu_torch.ops.kernels import _launch, _weights
from style_transfer_tpu_torch.ops.kernels import resnet as RK
from style_transfer_tpu_torch.ops.kernels import tolerances as T


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(k, r):
    k, r = k.detach().float(), r.detach().float()
    return float(torch.linalg.vector_norm(k - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))


def _bf(shape, dev, gen, scale=1.0, positive=False):
    t = torch.randn(shape, generator=gen, device=dev) * scale
    if positive:
        t = torch.relu(t)
    return t.to(torch.bfloat16)


# (H, W, K, N, stride, residual, relu): the 2048^2 cell's forward shapes, then edges
FWD = {
    "stem_cols": (1024, 1024, 152, 64, 1, False, True),
    "s1_reduce": (512, 512, 256, 64, 1, False, True),
    "s1_expand": (512, 512, 64, 256, 1, True, True),
    "s1_project": (512, 512, 64, 256, 1, False, False),
    "s2_project": (512, 512, 256, 512, 2, False, False),
    "s2_cols": (256, 256, 1152, 128, 1, False, True),
    "s3_reduce": (128, 128, 1024, 256, 1, False, True),
    "s3_expand": (128, 128, 256, 1024, 1, True, True),
    "s4_reduce": (64, 64, 2048, 512, 1, False, True),
    "s4_expand": (64, 64, 512, 2048, 1, True, True),
    "s4_project": (128, 128, 1024, 2048, 2, False, False),
    "odd": (37, 23, 72, 136, 1, True, True),
    "odd_stride2": (37, 23, 64, 200, 2, False, False),
    "tiny": (3, 5, 64, 64, 1, True, False),
}

# (H, W, K, N, add, add_sub, gate): backward-data shapes
BWD = {
    "stem_dcols": (1024, 1024, 64, 152, False, False, False),
    "s1_dh2": (512, 512, 256, 64, False, False, True),
    "s1_dx": (512, 512, 64, 256, True, False, True),
    "s2_head_dx": (512, 512, 128, 256, True, True, False),
    "s2_dcols": (256, 256, 128, 1152, False, False, False),
    "s3_dh2": (128, 128, 1024, 256, False, False, True),
    "s4_dx": (64, 64, 512, 2048, True, False, True),
    "s4_dsc": (64, 64, 2048, 1024, False, False, False),
    "odd_sub": (37, 23, 64, 72, True, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FWD))
def test_cuda_conv1x1_fwd_matches_plain(name, cuda_device):
    h, w, k, n, stride, residual, relu = FWD[name]
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = _bf((h, w, k), cuda_device, g, positive=True)
    wt = _bf((k, n), cuda_device, g, scale=(2.0 / k) ** 0.5)
    b = _bf((n,), cuda_device, g, scale=0.1)
    ho, wo = _launch.strided_hw(h, w, stride)
    res = _bf((ho, wo, n), cuda_device, g) if residual else None
    before = RK.launches.n
    y = _launch.conv1x1_fwd(x, wt, b, stride=stride, residual=res, relu=relu, count=RK.launches)
    assert RK.launches.n == before + 1
    ref = RK.conv1x1_plain(x, wt, b, stride=stride, add=res, relu=relu)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert _rel(y, ref) < T.TOL_ACT


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BWD))
def test_cuda_conv1x1_bwd_data_matches_plain(name, cuda_device):
    h, w, k, n, add, add_sub, gate = BWD[name]
    g = torch.Generator(device=cuda_device).manual_seed(2)
    dy = _bf((h, w, k), cuda_device, g)
    wt = _bf((k, n), cuda_device, g, scale=(2.0 / k) ** 0.5)
    shape = _launch.strided_hw(h, w, 2) + (n,) if add_sub else (h, w, n)
    a = _bf(shape, cuda_device, g) if add else None
    gt = _bf((h, w, n), cuda_device, g) if gate else None
    y = _launch.conv1x1_bwd_data(dy, wt, add=a, add_sub=add_sub, gate=gt, count=RK.launches)
    ref = RK.conv1x1_plain(dy, wt, add=a, add_sub=add_sub, gate=gt)
    assert _rel(y, ref) < T.TOL_ACT
    if gate:
        assert bool((y[gt <= 0] == 0).all())


# (launcher, shape) at the tile width ``_launch.conv1x1_width`` gives it
# (64: N = 64, 136, 152, and every gated launch; 128: N = 72, 128, 200, 256
# and up without a gate), so that each width runs: K of one chunk (64) and
# with a ragged last chunk (152), ragged pixel edges, stride 2 through TMA
# element strides, add_sub at odd extents, an add and a gate together,
# persistent grids of one tile, of fewer tiles than SMs and of many times
# more, and N not a multiple of 64 over more pixel tiles than SMs (a block
# then takes a pixel tile's N tiles itself)
WIDTH_CASES = {
    "k64_n64": ("conv1x1_fwd", (512, 512, 64, 64, 1, False, True)),
    "k64_n256": ("conv1x1_fwd", (512, 512, 64, 256, 1, True, True)),
    "k152_stem": ("conv1x1_fwd", (1024, 1024, 152, 64, 1, False, True)),
    "k152_n128_odd": ("conv1x1_fwd", (37, 23, 152, 128, 1, True, True)),
    "n152_stem_bwd": ("conv1x1_bwd_data", (1024, 1024, 64, 152, False, False, False)),
    "k152_n152_odd": ("conv1x1_bwd_data", (37, 23, 152, 152, True, False, True)),
    "few_tiles": ("conv1x1_fwd", (64, 64, 2048, 512, 1, False, True)),
    "few_tiles_gate": ("conv1x1_bwd_data", (64, 64, 2048, 512, False, False, True)),
    "one_tile": ("conv1x1_bwd_data", (5, 9, 64, 64, True, False, True)),
    "one_tile_n128": ("conv1x1_fwd", (5, 9, 64, 128, 1, True, False)),
    "stride2_odd": ("conv1x1_fwd", (37, 23, 64, 136, 2, True, True)),
    "stride2_proj": ("conv1x1_fwd", (128, 128, 1024, 2048, 2, False, False)),
    "sub_odd": ("conv1x1_bwd_data", (37, 23, 64, 72, True, True, False)),
    "sub_odd_n64": ("conv1x1_bwd_data", (37, 23, 128, 64, True, True, False)),
    "sub_odd_gate": ("conv1x1_bwd_data", (19, 45, 128, 200, True, True, True)),
    "add_gate": ("conv1x1_bwd_data", (256, 256, 128, 512, True, False, True)),
    "add_n512": ("conv1x1_bwd_data", (256, 256, 128, 512, True, False, False)),
    "n200_own_rows": ("conv1x1_fwd", (200, 100, 64, 200, 1, True, True)),
}


def _conv1x1_case(kernel, shape, dev, seed):
    """``(run(), plain fp32 result, gate or None)`` of one launch on random
    bf16 operands."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kernel == "conv1x1_fwd":
        h, w, k, n, stride, residual, relu = shape
        x = _bf((h, w, k), dev, g, positive=True)
        wt = _bf((k, n), dev, g, scale=(2.0 / k) ** 0.5)
        b = _bf((n,), dev, g, scale=0.1)
        res = _bf(_launch.strided_hw(h, w, stride) + (n,), dev, g) if residual else None
        return (lambda: _launch.conv1x1_fwd(x, wt, b, stride=stride, residual=res, relu=relu,
                                            count=RK.launches),
                RK.conv1x1_plain(x, wt, b, stride=stride, add=res, relu=relu), None)
    h, w, k, n, add, add_sub, gate = shape
    dy = _bf((h, w, k), dev, g)
    wt = _bf((k, n), dev, g, scale=(2.0 / k) ** 0.5)
    a = _bf(_launch.strided_hw(h, w, 2) + (n,) if add_sub else (h, w, n), dev, g) if add else None
    gt = _bf((h, w, n), dev, g) if gate else None
    return (lambda: _launch.conv1x1_bwd_data(dy, wt, add=a, add_sub=add_sub, gate=gt,
                                             count=RK.launches),
            RK.conv1x1_plain(dy, wt, add=a, add_sub=add_sub, gate=gt), gt)


def _case_width(kernel, shape):
    return _launch.conv1x1_width(shape[3], kernel == "conv1x1_bwd_data" and shape[6])


def _case_tiles(kernel, shape):
    """Output tiles of the launch: 8 x 16 pixels x its width's channels."""
    ho, wo = _launch.strided_hw(shape[0], shape[1], shape[4]) if kernel == "conv1x1_fwd" \
        else shape[:2]
    th, tw = _launch.CONV1X1_TILE
    return -(-ho // th) * -(-wo // tw) * -(-shape[3] // _case_width(kernel, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDTH_CASES))
def test_cuda_conv1x1_each_width_matches_plain(name, cuda_device):
    kernel, shape = WIDTH_CASES[name]
    run, ref, gate = _conv1x1_case(kernel, shape, cuda_device, 8)
    y = run()
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert _rel(y, ref) < T.TOL_ACT
    if gate is not None:
        assert bool((y[gate <= 0] == 0).all())


@pytest.mark.cuda
def test_cuda_conv1x1_cases_span_widths_and_grids(cuda_device):
    """The width cases run both tile widths, each over persistent grids of
    one tile, of fewer tiles than the card's SMs and of more than eight
    times as many (the grid is one block an SM, each walking its tiles)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for width in _launch.CONV1X1_WIDTHS:
        tiles = [_case_tiles(k, sh) for k, sh in WIDTH_CASES.values()
                 if _case_width(k, sh) == width]
        assert min(tiles) == 1, width
        assert any(1 < t < sms for t in tiles) and max(tiles) > 8 * sms, width


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k64_n64", "k64_n256", "n152_stem_bwd", "sub_odd_gate",
                                  "add_gate", "add_n512"])
def test_cuda_conv1x1_launches_repeat_bit_for_bit(name, cuda_device):
    """Two launches on the same inputs give the same bits: every output has
    one owner that sums in a fixed order, whatever tile a block walks when."""
    kernel, shape = WIDTH_CASES[name]
    run, _, _ = _conv1x1_case(kernel, shape, cuda_device, 9)
    first = run()
    assert torch.equal(first, run())


@pytest.mark.cuda
@pytest.mark.parametrize("width, gate", [(96, False), (128, True)])
def test_cuda_conv1x1_library_refuses_what_it_does_not_build(width, gate, cuda_device):
    """The library builds tiles 64 and 128 wide and a gate only at 64 (where
    the launcher sends every gated launch); it refuses the rest."""
    from style_transfer_tpu_torch.ops.kernels._build import library

    x = torch.zeros(16, 16, 64, dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros(64, 128, dtype=torch.bfloat16, device=cuda_device)
    y = torch.empty(16, 16, 128, dtype=torch.bfloat16, device=cuda_device)
    g = torch.ones_like(y) if gate else None
    err = library().st_conv1x1(x.data_ptr(), w.data_ptr(), None, None,
                               g.data_ptr() if gate else None, y.data_ptr(), 16, 16, 64, 128,
                               1, 0, 0, width, torch.cuda.current_stream().cuda_stream)
    assert err != 0


# (H, W, C, k, stride, Kp, gate)
COLS = {
    "stem": (2048, 2048, 3, 7, 2, 152, False),
    "s2": (512, 512, 128, 3, 2, 1152, True),
    "s4": (128, 128, 512, 3, 2, 4608, True),
    "odd_stem": (37, 23, 3, 7, 2, 152, False),
    "odd": (37, 23, 16, 3, 2, 144, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(COLS))
def test_cuda_im2col_and_col2im_match_plain(name, cuda_device):
    h, w, c, k, stride, kp, gate = COLS[name]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = _bf((h, w, c), cuda_device, g)
    col = _launch.im2col(x, k, k, stride, kp, count=RK.launches)
    assert torch.equal(col, RK.im2col_plain(x, k, k, stride, kp))
    dcol = _bf(col.shape, cuda_device, g)
    gt = _bf((h, w, c), cuda_device, g) if gate else None
    dx = _launch.col2im(dcol, (h, w), c, k, k, stride, gate=gt, count=RK.launches)
    assert _rel(dx, RK.col2im_plain(dcol, (h, w), c, k, k, stride, gate=gt)) < T.TOL_ACT


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1024, 1024), (37, 23), (2, 3)])
def test_cuda_maxpool_matches_plain(hw, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = _bf(hw + (64,), cuda_device, g, positive=True)  # post-ReLU: ties at zero
    y, idx = _launch.maxpool_fwd(x, count=RK.launches)
    ry, ridx = RK.maxpool_plain(x)
    assert torch.equal(y, ry) and torch.equal(idx, ridx)
    ref_pool = F.max_pool2d(x.float().permute(2, 0, 1)[None], 3, 2, 1)[0].permute(1, 2, 0)
    assert torch.equal(y.float(), ref_pool)
    dy = _bf(y.shape, cuda_device, g)
    add = _bf(x.shape, cuda_device, g)
    dx = _launch.maxpool_bwd(dy, idx, hw, add=add, gate=x, count=RK.launches)
    assert _rel(dx, RK.maxpool_bwd_plain(dy, idx, hw, add=add, gate=x)) < T.TOL_ACT
    gated = _launch.relu_gate(add, x, count=RK.launches)
    assert torch.equal(gated, RK.relu_gate_plain(add, x))


def _params(dev):
    p = R.init_params(5)
    return {n: {k: v.to(dev) for k, v in d.items()} for n, d in p.items()}


def _grad_errors(fn, plain, x0, wts):
    """Relative errors of ``fn``'s outputs and input gradient against the
    plain forward in fp32, and of the plain forward in bf16 against the
    same: ``(kernel, plain bf16)`` for the outputs and for the gradient."""
    out = {}
    for name, f, dtype in (("k", fn, torch.bfloat16), ("f", plain, torch.float32),
                           ("b", plain, torch.bfloat16)):
        x = x0.detach().to(dtype).clone().requires_grad_(True)
        ys = f(x)
        sum(torch.sum(y.float() * w) for y, w in zip(ys, wts)).backward()
        out[name] = ([y.detach().float() for y in ys], x.grad.float())
    acts = [(_rel(k, f), _rel(b, f)) for k, f, b in zip(out["k"][0], out["f"][0], out["b"][0])]
    return acts, (_rel(out["k"][1], out["f"][1]), _rel(out["b"][1], out["f"][1]))


def _segments(p):
    """(name, kernel route, plain route, input channels, input extent)."""
    stem = (lambda x: RK.stem_pool(x, p["conv1"]["kernel"], p["conv1"]["bias"]),
            lambda x: (R.max_pool(R.stem(p, x)), R.stem(p, x)))
    yield "stem", stem[0], stem[1], 3, (70, 54)
    cin = R.STEM_CHANNELS
    for s, (_, width, _) in enumerate(R.STAGES, start=1):
        yield (f"layer{s}", lambda x, s=s: (RK.stage(x, p, s),),
               lambda x, s=s: (R.stage_forward(p, x, s),), cin, (35, 27))
        cin = width * R.EXPANSION


@pytest.mark.cuda
def test_cuda_resnet_segments_match_fp32(cuda_device):
    """The stem with its pool and each stage alone, at odd extents, against
    the plain fp32 forward on the same bf16 weights: the stem's output
    within TOL_ACT and its input gradient within TOL_DX, each no less
    accurate than the plain forward in bf16 (``tolerances.within``); a
    stage (3-6 bottlenecks, 10-19 convolutions: the limits are calibrated
    on one or two, and a stage's gradient through bf16 lies 0.08 from fp32
    on the plain bf16 route too) no less accurate than the plain bf16
    forward, output and gradient."""
    p = {n: {k: v.to(torch.bfloat16).float() for k, v in d.items()}
         for n, d in _params(cuda_device).items()}
    g = torch.Generator(device=cuda_device).manual_seed(6)
    for name, fn, plain, cin, hw in _segments(p):
        x0 = torch.randn((1,) + hw + (cin,), generator=g, device=cuda_device)
        if cin > 3:
            x0 = torch.relu(x0)
        shapes = [y.shape for y in plain(x0)]
        wts = [torch.randn(sh, generator=g, device=cuda_device) for sh in shapes]
        acts, (dx, dx_plain) = _grad_errors(fn, plain, x0, wts)
        pairs = acts + [(dx, dx_plain)]
        for (rel, plain_rel), tol in zip(pairs, [T.TOL_ACT] * len(acts) + [T.TOL_DX]):
            if name == "stem":
                assert T.within(rel, plain_rel, tol), (name, rel, plain_rel)
            assert rel <= T.PLAIN_RATIO * plain_rel + T.PLAIN_SLACK, (name, rel, plain_rel)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 192), (70, 54)])
def test_cuda_resnet_layers_and_gradient_match_fp32(hw, cuda_device):
    """Every named layer, and the gradient of a loss on all of them, of the
    whole network on the kernels against the plain fp32 forward on the same
    bf16 weights, no less accurate than the plain forward in bf16: through
    50 convolutions the bf16 roundings and the ReLU and max-pool decisions
    they flip add up, on either bf16 route alike."""
    p = {n: {k: v.to(torch.bfloat16).float() for k, v in d.items()}
         for n, d in _params(cuda_device).items()}
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x0 = torch.randn((1,) + hw + (3,), generator=g, device=cuda_device)

    def kernels(x):
        pooled, act = RK.stem_pool(x, p["conv1"]["kernel"], p["conv1"]["bias"])
        outs = [act]
        for s in range(1, 5):
            pooled = RK.stage(pooled, p, s)
            outs.append(pooled)
        return outs

    def plain(x):
        f = R.extract_features(p, x, R.LAYER_NAMES)
        return [f[n] for n in R.LAYER_NAMES]

    wts = [torch.randn(y.shape, generator=g, device=cuda_device) for y in plain(x0)]
    acts, (dx, dx_plain) = _grad_errors(kernels, plain, x0, wts)
    for name, (rel, plain_rel) in zip(R.LAYER_NAMES, acts):
        assert rel <= T.PLAIN_RATIO * plain_rel + T.PLAIN_SLACK, (name, rel, plain_rel)
    assert dx <= T.PLAIN_RATIO * dx_plain + T.PLAIN_SLACK, (dx, dx_plain)


@pytest.mark.cuda
def test_cuda_resnet_objective_uses_no_library_conv_or_matmul(cuda_device, monkeypatch):
    """One evaluation of the ResNet objective at 512^2 on the kernel route,
    forward and backward, with the library's convolutions and products
    patched to raise: no layer is carried by them."""
    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig

    st = StyleTransfer(R.init_params(0), device=cuda_device)
    cfg = StylizeConfig(size=512, min_scale=512, content_layers=("layer2",),
                        style_layers=R.LAYER_NAMES)
    r = np.random.RandomState(0)
    img = torch.from_numpy(r.rand(1, 512, 512, 3).astype(np.float32)).to(cuda_device)

    def refuse(*a, **k):
        raise AssertionError("a library convolution or product ran")

    targets = (st._capture_content(cfg, img), st._capture_style(cfg, img))
    for mod, names in ((F, ("conv2d", "linear")), (torch, ("matmul", "mm", "bmm", "einsum"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    objective = st._build_objective(cfg)
    x = img.clone().requires_grad_(True)
    loss, _ = objective(x, *targets)
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0
    assert all(form != "plain" for _, form in st.last_route)


@pytest.mark.cuda
def test_cuda_resnet_weight_cotangents_are_none(cuda_device):
    p = _params(cuda_device)
    for d in p.values():
        for v in d.values():
            v.requires_grad_(True)
    x = torch.randn(1, 64, 64, 3, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    pooled, act = RK.stem_pool(x, p["conv1"]["kernel"], p["conv1"]["bias"])
    out = RK.stage(pooled, p, 1)
    (out.float().sum() + act.float().sum()).backward()
    assert x.grad is not None
    assert all(v.grad is None for d in p.values() for v in d.values())


@pytest.mark.cuda
def test_cuda_conv1x1_tile_is_the_built_librarys(cuda_device):
    import ctypes

    from style_transfer_tpu_torch.ops.kernels._build import library

    out = (ctypes.c_int * 7)()
    for width in _launch.CONV1X1_WIDTHS:
        assert library().st_conv1x1_info(width, out) == 0
        th, tw, bn, _, smem, minb, kc = out
        assert (th, tw) == _launch.CONV1X1_TILE and bn == width and kc == _launch.CONV1X1_KC
        assert minb == _launch.CONV1X1_BLOCKS_PER_SM and minb * smem <= 228 * 1024
    assert library().st_conv1x1_info(96, out) != 0
    assert _weights.gemm_operand(torch.zeros(7, 7, 3, 64)).shape == (R.STEM_COLUMNS, 64)


# (M, C) of ResNet-50's Grams at the 2048^2 cell, then ragged rows at its
# widest channels
GRAMS = {"conv1": (1024 * 1024, 64), "layer1": (512 * 512, 256), "layer2": (256 * 256, 512),
         "layer3": (128 * 128, 1024), "layer4": (64 * 64, 2048), "odd_1024": (37 * 23, 1024),
         "odd_2048": (5 * 7, 2048)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAMS))
def test_cuda_gram_matches_fp32_and_repeats_bit_for_bit(name, cuda_device):
    """``pallas_gram`` (``csrc/gram.cu``: F^T F / M forward, the bf16 ``F (g
    + g^T) / M`` backward) at ResNet-50's Gram shapes: the Gram within
    TOL_GRAM and the activation's gradient within TOL_ACT of fp32, each no
    less accurate than the same products in plain bf16; two calls give the
    same bits; each launch's counted shape ends with the configuration the
    choosers give its (M, C)."""
    from style_transfer_tpu_torch import trace
    from style_transfer_tpu_torch.ops.kernels import gram as KG

    m, c = GRAMS[name]
    g = torch.Generator(device=cuda_device).manual_seed(m + c)
    f = torch.relu(torch.randn(1, 1, m, c, generator=g, device=cuda_device)).to(torch.bfloat16)
    ct = torch.randn(c, c, generator=g, device=cuda_device) * 1e-3

    def run():
        x = f.detach().requires_grad_(True)
        gram = KG.pallas_gram(x)
        (dx,) = torch.autograd.grad(gram, x, ct)
        return gram, dx

    trace.clear()
    with trace.recording():
        g1, d1 = run()
    keys = {kernel: shape for (_, kernel, shape) in trace.counts()}
    trace.clear()
    g2, d2 = run()
    f2 = f.view(m, c)
    ref = f2.float().T @ f2.float() / m
    plain = (f2.T @ f2).float() / m
    sym = (ct + ct.T) / m
    dref = f2.float() @ sym.to(torch.bfloat16).float()
    dplain = (f2 @ sym.to(torch.bfloat16)).float()
    assert T.within(_rel(g1, ref), _rel(plain, ref), T.TOL_GRAM), (_rel(g1, ref), _rel(plain, ref))
    assert T.within(_rel(d1.view(m, c), dref), _rel(dplain, dref), T.TOL_ACT)
    assert torch.equal(g1, g2) and torch.equal(d1, d2)
    assert keys["gram"][-1] == _launch.gram_config(m, c)
    assert keys["gram_fs"][-1] == _launch.gram_fs_width(m, c)


@pytest.mark.cuda
def test_cuda_gram_model_is_the_built_librarys(cuda_device):
    """The Gram launchers' rows per step and per F S tile are those compiled
    into ``csrc/gram.cu``."""
    from style_transfer_tpu_torch.ops.kernels import selfcheck
    from style_transfer_tpu_torch.ops.kernels._build import library

    assert selfcheck.gram_model_matches(library())
