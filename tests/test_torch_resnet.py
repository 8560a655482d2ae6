"""ResNet-50 in the port on the CPU: its plain forward and objective against
the benchmark's plain reference (``stbench/arch/resnet50.py``, loaded by
path) at the published widths, batch-norm folding against eval-mode batch
norm, the architecture's inference and errors, and the plain form of each
kernel wrapper (``ops/kernels/resnet.py``) against ``F.conv2d`` and
``F.max_pool2d`` under autograd. No JAX: the JAX package has no ResNet."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from style_transfer_tpu_torch import StyleTransfer, StylizeConfig, models
from style_transfer_tpu_torch.models import resnet as R
from style_transfer_tpu_torch.ops.kernels import _launch
from style_transfer_tpu_torch.ops.kernels import resnet as RK
from style_transfer_tpu_torch.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The reference architecture and objective, by path (the benchmark's
    tree imports from its checkout's root)."""
    sys.path.insert(0, str(REPO))
    try:
        arch = _load("stbench_arch_resnet50_test", REPO / "stbench" / "arch" / "resnet50.py")
        from stbench.reference.objective import Objective
    finally:
        sys.path.remove(str(REPO))
    config = json.loads((REPO / "stbench" / "configs" / "resnet50-gatys-adam.json").read_text())
    return arch, Objective, config


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def params(ref):
    arch, _, config = ref
    torch.manual_seed(0)
    return arch.weights(11, "cpu", config)


@pytest.mark.parametrize("hw", [(64, 48), (70, 54)])
def test_plain_resnet_matches_the_reference(ref, params, hw):
    """Every named layer, then the objective's loss and image gradient, of
    the port's plain path (and of the kernel route's CPU forms) against the
    reference, within 1e-5 relative. The images are the benchmark's own
    kind (``stbench.inputs.image``: octaves of noise): with white noise for
    both images at 64x48, layer3's and layer4's Grams (4x3 and 2x2 pixels)
    of the two nearly coincide, their difference cancels to ~1e-5 of a
    Gram, and the ~1e-7 by which two fp32 summation orders differ becomes
    ~5e-3 of the gradient on either side alike."""
    arch, Objective, config = ref
    torch.set_num_threads(4)
    sys.path.insert(0, str(REPO))
    try:
        from stbench import inputs
    finally:
        sys.path.remove(str(REPO))
    content_u8, style_u8 = inputs.images(7, 0, hw, hw, "cpu")
    img = content_u8[None].float() / 255
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    x = (img - torch.tensor(mean)) / torch.tensor(std)
    mine = R.extract_features(params, x, R.LAYER_NAMES)
    theirs = arch.features(arch.prepare(params), x.permute(0, 3, 1, 2), R.LAYER_NAMES,
                           lambda t: t)
    for name in R.LAYER_NAMES:
        assert mine[name].shape[1:3] == theirs[name].shape[2:], name
        assert _rel(mine[name], theirs[name].permute(0, 2, 3, 1)) < RTOL, name

    fields = config["stylize"]
    obj = Objective(arch, params, mean, std, fields)
    style = style_u8[None].float() / 255
    targets = obj.targets(img, style)
    loss_ref, grad_ref = obj.value_and_grad(img, targets)

    for fused in (False, True):
        st = StyleTransfer(params, mean=mean, std=std, device="cpu")
        cfg = StylizeConfig(content_layers=tuple(fields["content_layers"]),
                            style_layers=tuple(fields["style_layers"]), use_fused=fused)
        c_t = st._capture_content(cfg, img)
        s_t = st._capture_style(cfg, style)
        x_img = img.clone().requires_grad_(True)
        loss, _ = st._build_objective(cfg)(x_img, c_t, s_t)
        loss.backward()
        assert abs(float(loss.detach()) - float(loss_ref)) <= RTOL * abs(float(loss_ref))
        assert _rel(x_img.grad, grad_ref) < RTOL
        assert st.last_route[0] == (("conv1", "im2col_gemm") if fused else ("resnet50", "plain"))


def test_fold_batch_norm_is_eval_mode_batch_norm():
    """A torchvision-format state dict with random batch-norm statistics:
    the folded network equals conv -> eval-mode batch norm, layer by layer."""
    g = torch.Generator().manual_seed(2)
    sd = {}
    for name, (kh, kw, cin, cout, _) in R.CONV_SHAPES.items():
        wkey = name + (".0.weight" if name.endswith("downsample") else ".weight")
        sd[wkey] = torch.randn(cout, cin, kh, kw, generator=g) * (2.0 / (kh * kw * cin)) ** 0.5
        bn = ("bn1" if name == "conv1" else name + ".1" if name.endswith("downsample")
              else name[:-5] + "bn" + name[-1])
        sd[f"{bn}.weight"] = 0.5 + torch.rand(cout, generator=g)
        sd[f"{bn}.bias"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{bn}.running_mean"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{bn}.running_var"] = 0.5 + torch.rand(cout, generator=g)
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    folded = R.fold_batch_norm(sd)
    assert set(folded) == set(R.CONV_NAMES)

    def conv_bn(x, name, relu):
        _, _, _, _, stride = R.CONV_SHAPES[name]
        wkey = name + (".0.weight" if name.endswith("downsample") else ".weight")
        bn = ("bn1" if name == "conv1" else name + ".1" if name.endswith("downsample")
              else name[:-5] + "bn" + name[-1])
        w = sd[wkey]
        y = F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)
        y = F.batch_norm(y, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                         sd[f"{bn}.weight"], sd[f"{bn}.bias"], training=False, eps=R.BN_EPS)
        return torch.relu(y) if relu else y

    x = torch.randn(1, 3, 40, 36, generator=g)
    y = conv_bn(x, "conv1", True)
    want = {"conv1": y}
    y = F.max_pool2d(y, 3, 2, 1)
    for s, (n, _, _) in enumerate(R.STAGES, start=1):
        for b in range(n):
            pre = f"layer{s}.{b}."
            h = conv_bn(conv_bn(y, pre + "conv1", True), pre + "conv2", True)
            sc = conv_bn(y, pre + "downsample", False) if b == 0 else y
            y = torch.relu(conv_bn(h, pre + "conv3", False) + sc)
        want[f"layer{s}"] = y
    got = R.extract_features(folded, x.permute(0, 2, 3, 1), R.LAYER_NAMES)
    for name in R.LAYER_NAMES:
        assert _rel(got[name], want[name].permute(0, 2, 3, 1)) < 1e-5, name


def test_infer_arch_picks_resnet50_and_refuses_a_partial_set():
    p = R.init_params(0)
    assert models.infer_arch(p) == "resnet50"
    assert models.infer_arch({f"conv{b}_{i}": 0 for b, n in ((1, 2), (2, 2), (3, 4), (4, 4),
                                                              (5, 4)) for i in range(1, n + 1)}) \
        == "vgg19"
    partial = {k: v for k, v in p.items() if k != "layer4.2.conv3"}
    with pytest.raises(ValueError, match="match no supported arch"):
        models.infer_arch(partial)
    with pytest.raises(ValueError, match="match no supported arch"):
        StyleTransfer(partial, device="cpu")


def test_resnet_errors():
    p = R.init_params(0)
    st = StyleTransfer(p, device="cpu")
    assert st.arch == "resnet50" and st.pooling == "max"
    r = np.random.RandomState(0)
    img = r.rand(32, 32, 3).astype(np.float32)
    with pytest.raises(ValueError, match=r"unknown resnet50 layer.*'conv4_2'.*layer4"):
        st.stylize(img, img, StylizeConfig(size=32, min_scale=32, iterations=(1,)))
    with pytest.raises(ValueError, match="does not run on a mesh"):
        StyleTransfer(p, device="cpu", mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="pools with its stem's 'max' pool"):
        StyleTransfer(p, device="cpu", pooling="average")
    assert StyleTransfer(p, device="cpu", pooling="max").pooling == "max"
    assert StyleTransfer(device="cpu").pooling == "average"


def test_remat_threshold_comes_from_resnets_own_bytes():
    from style_transfer_tpu_torch import networks

    st = StyleTransfer(R.init_params(0), device="cpu")
    cfg = StylizeConfig(content_layers=("layer2",), style_layers=("conv1", "layer4"))

    def use_remat(side):
        plan = st._plan(cfg, (side, side), cfg.content_layers, cfg.style_layers)
        assert plan.full  # the kernels carry every layer: ResNet's own threshold
        return st._use_remat(cfg, plan, side, side)

    assert networks.REMAT_AUTO_PIXELS_RESNET == int(57220 * 2 ** 20 / R.peak_bytes_per_pixel())
    assert not use_remat(2048) and not use_remat(8192)
    assert use_remat(12288)
    assert R.peak_bytes_per_pixel() == 463.0


def _pair(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g), torch.Generator().manual_seed(seed + 100)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(9, 7), (8, 12)])
def test_conv1x1_plain_is_a_1x1_conv_and_its_adjoint(stride, hw):
    x, g = _pair(hw + (16,), 1)
    w = torch.randn(16, 24, generator=g)
    b = torch.randn(24, generator=g)
    ho, wo = _launch.strided_hw(*hw, stride)
    res = torch.randn(ho, wo, 24, generator=g)
    xr = x.clone().requires_grad_(True)
    want = F.conv2d(xr.permute(2, 0, 1)[None], w.T[:, :, None, None], b, stride=stride)[0]
    want = torch.relu(want.permute(1, 2, 0) + res)
    got = RK.conv1x1_plain(x, w, b, stride=stride, add=res, relu=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dy = torch.randn(ho, wo, 24, generator=g)
    want.backward(dy)
    # backward-data: the gated cotangent times the transposed weights,
    # landing on the even pixels for stride 2
    gated = RK.relu_gate_plain(dy, want.detach())
    if stride == 2:
        sub = RK.conv1x1_plain(gated, w.T)
        dx = RK.conv1x1_plain(torch.zeros(hw + (24,)), w.T, add=sub, add_sub=True)
    else:
        dx = RK.conv1x1_plain(gated, w.T)
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-5)
    gate = torch.randn(hw + (16,), generator=g)
    gx = RK.conv1x1_plain(gated, w.T, gate=gate[::stride, ::stride])
    assert bool((gx[gate[::stride, ::stride] <= 0] == 0).all())


@pytest.mark.parametrize("k, stride, c, kp", [(3, 2, 8, 72), (7, 2, 3, 152), (3, 1, 4, 40)])
@pytest.mark.parametrize("hw", [(11, 9), (12, 16)])
def test_im2col_gemm_is_the_strided_conv_and_col2im_its_adjoint(k, stride, c, kp, hw):
    x, g = _pair(hw + (c,), 2)
    w = torch.randn(k, k, c, 6, generator=g)
    col = RK.im2col_plain(x, k, k, stride, kp)
    assert col.shape[2] == kp and bool((col[:, :, k * k * c:] == 0).all())
    wmat = torch.zeros(kp, 6)
    wmat[:k * k * c] = w.reshape(-1, 6)
    xr = x.clone().requires_grad_(True)
    want = F.conv2d(xr.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1), stride=stride,
                    padding=k // 2)[0].permute(1, 2, 0)
    torch.testing.assert_close(RK.conv1x1_plain(col, wmat), want, rtol=1e-5, atol=1e-5)
    dy = torch.randn(want.shape, generator=g)
    want.backward(dy)
    dcol = RK.conv1x1_plain(dy, wmat.T)
    torch.testing.assert_close(RK.col2im_plain(dcol, hw, c, k, k, stride), xr.grad, rtol=1e-5,
                               atol=1e-5)
    gate = torch.randn(hw + (c,), generator=g)
    gated = RK.col2im_plain(dcol, hw, c, k, k, stride, gate=gate)
    torch.testing.assert_close(gated, torch.where(gate > 0, xr.grad, 0.0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(9, 7), (8, 12), (2, 3)])
def test_maxpool_plain_is_max_pool2d_and_its_adjoint(hw):
    x, g = _pair(hw + (8,), 3)
    x = torch.relu(x).round(decimals=1)  # ties, as after a ReLU in bf16
    xr = x.clone().requires_grad_(True)
    want = F.max_pool2d(xr.permute(2, 0, 1)[None], 3, 2, 1)[0].permute(1, 2, 0)
    y, idx = RK.maxpool_plain(x)
    torch.testing.assert_close(y, want.detach())
    assert idx.dtype == torch.int8 and int(idx.max()) <= 8
    dy = torch.randn(want.shape, generator=g)
    want.backward(dy)
    torch.testing.assert_close(RK.maxpool_bwd_plain(dy, idx, hw), xr.grad)
    add = torch.randn(hw + (8,), generator=g)
    got = RK.maxpool_bwd_plain(dy, idx, hw, add=add, gate=x)
    torch.testing.assert_close(got, torch.where(x > 0, xr.grad + add, 0.0))


def test_the_wrappers_cpu_forms_are_the_models_and_freeze_the_weights():
    p = R.init_params(3)
    for d in p.values():
        for v in d.values():
            v.requires_grad_(True)
    x = torch.rand(1, 40, 34, 3, requires_grad=True)
    pooled, act = RK.stem_pool(x, p["conv1"]["kernel"], p["conv1"]["bias"])
    torch.testing.assert_close(act, R.stem(p, x))
    torch.testing.assert_close(pooled, R.max_pool(act))
    out = RK.stage(pooled, p, 1)
    out2 = RK.stage(out, p, 2)
    torch.testing.assert_close(out2, R.stage_forward(p, R.stage_forward(p, pooled, 1), 2))
    (out2.sum() + act.sum()).backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    assert all(v.grad is None for d in p.values() for v in d.values())
    assert RK.launches.n == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        RK.stage(torch.zeros(1, 4, 4, 64, device="meta"), p, 1)


def _step_launches(monkeypatch, size):
    """The kernel launches of one objective step (forward through the stem
    and the four stages, backward from every layer) at ``size``², as
    ``trace.counts()`` records them: the wrappers' own code on shape-only
    (meta) tensors, with the library's entry points, the checks of device
    and alignment, and the stream read replaced."""
    from style_transfer_tpu_torch import trace
    from style_transfer_tpu_torch.ops.kernels import _weights

    class _Library:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_launch, "library", lambda: _Library())
    monkeypatch.setattr(_launch, "_require", lambda *args, **kwargs: None)
    monkeypatch.setattr(_launch, "_stream", lambda: 0)
    meta = {"device": "meta"}
    p = {n: {"kernel": torch.empty(kh, kw, ci, co, **meta), "bias": torch.empty(co, **meta)}
         for n, (kh, kw, ci, co, _) in R.CONV_SHAPES.items()}
    x = torch.empty(1, size, size, 3, dtype=torch.bfloat16, requires_grad=True, **meta)
    trace.clear()
    before = RK.launches.n
    try:
        with trace.recording():
            pooled, act = RK.StemPoolFunction.apply(x, p["conv1"]["kernel"], p["conv1"]["bias"])
            outs = [act]
            for s in range(1, 5):
                pooled = RK.StageFunction.apply(pooled, s, *RK.stage_weights(p, s))
                outs.append(pooled)
            torch.autograd.backward(outs, [torch.empty(o.shape, dtype=torch.bfloat16, **meta)
                                           for o in outs])
        return dict(trace.counts())
    finally:
        trace.clear()
        _weights.clear()
        RK.launches.n = before


# The 1x1 GEMM launches of one 2048^2 step of ``resnet50-adam-2048``:
# (launcher, shape) -> (launches, tile width of ``_launch.conv1x1_width``)
STEP_2048_CONV1X1 = {
    ("conv1x1_fwd", (1024, 1024, 152, 64, 1, False, True)): (1, 64),
    ("conv1x1_fwd", (512, 512, 64, 64, 1, False, True)): (1, 64),
    ("conv1x1_fwd", (512, 512, 64, 256, 1, True, True)): (3, 128),
    ("conv1x1_fwd", (512, 512, 64, 256, 1, False, False)): (1, 128),
    ("conv1x1_fwd", (512, 512, 256, 64, 1, False, True)): (2, 64),
    ("conv1x1_fwd", (512, 512, 256, 128, 1, False, True)): (1, 128),
    ("conv1x1_fwd", (512, 512, 256, 512, 2, False, False)): (1, 128),
    ("conv1x1_fwd", (256, 256, 1152, 128, 1, False, True)): (1, 128),
    ("conv1x1_fwd", (256, 256, 128, 512, 1, True, True)): (4, 128),
    ("conv1x1_fwd", (256, 256, 512, 128, 1, False, True)): (3, 128),
    ("conv1x1_fwd", (256, 256, 512, 256, 1, False, True)): (1, 128),
    ("conv1x1_fwd", (256, 256, 512, 1024, 2, False, False)): (1, 128),
    ("conv1x1_fwd", (128, 128, 2304, 256, 1, False, True)): (1, 128),
    ("conv1x1_fwd", (128, 128, 256, 1024, 1, True, True)): (6, 128),
    ("conv1x1_fwd", (128, 128, 1024, 256, 1, False, True)): (5, 128),
    ("conv1x1_fwd", (128, 128, 1024, 512, 1, False, True)): (1, 128),
    ("conv1x1_fwd", (128, 128, 1024, 2048, 2, False, False)): (1, 128),
    ("conv1x1_fwd", (64, 64, 4608, 512, 1, False, True)): (1, 128),
    ("conv1x1_fwd", (64, 64, 512, 2048, 1, True, True)): (3, 128),
    ("conv1x1_fwd", (64, 64, 2048, 512, 1, False, True)): (2, 128),
    ("conv1x1_bwd_data", (1024, 1024, 64, 152, False, False, False)): (1, 64),
    ("conv1x1_bwd_data", (512, 512, 64, 64, True, False, False)): (1, 64),
    ("conv1x1_bwd_data", (512, 512, 64, 256, True, False, True)): (2, 64),
    ("conv1x1_bwd_data", (512, 512, 256, 64, False, False, True)): (3, 64),
    ("conv1x1_bwd_data", (512, 512, 256, 64, False, False, False)): (1, 64),
    ("conv1x1_bwd_data", (512, 512, 128, 256, True, True, False)): (1, 128),
    ("conv1x1_bwd_data", (256, 256, 128, 1152, False, False, False)): (1, 128),
    ("conv1x1_bwd_data", (256, 256, 128, 512, True, False, True)): (3, 64),
    ("conv1x1_bwd_data", (256, 256, 512, 128, False, False, True)): (4, 64),
    ("conv1x1_bwd_data", (256, 256, 512, 256, False, False, False)): (1, 128),
    ("conv1x1_bwd_data", (256, 256, 256, 512, True, True, False)): (1, 128),
    ("conv1x1_bwd_data", (128, 128, 256, 2304, False, False, False)): (1, 128),
    ("conv1x1_bwd_data", (128, 128, 256, 1024, True, False, True)): (5, 64),
    ("conv1x1_bwd_data", (128, 128, 1024, 256, False, False, True)): (6, 64),
    ("conv1x1_bwd_data", (128, 128, 1024, 512, False, False, False)): (1, 128),
    ("conv1x1_bwd_data", (128, 128, 512, 1024, True, True, False)): (1, 128),
    ("conv1x1_bwd_data", (64, 64, 512, 4608, False, False, False)): (1, 128),
    ("conv1x1_bwd_data", (64, 64, 512, 2048, True, False, True)): (2, 64),
    ("conv1x1_bwd_data", (64, 64, 2048, 512, False, False, True)): (3, 64),
    ("conv1x1_bwd_data", (64, 64, 2048, 1024, False, False, False)): (1, 128),
}


def test_conv1x1_width_over_a_2048_step(monkeypatch):
    """The 80 launches of ``csrc/conv1x1.cu`` that one 2048^2 step of
    ResNet-50 records (stem, 16 bottlenecks, both directions; 132 wrapper
    launches in all), and the tile width each takes: 64 for N = 64 and the
    stem's N = 152, and where a launch reads a gate; 128 for the others.
    The width follows from the recorded shape, so the launch counter says
    how often each variant runs."""
    counts = _step_launches(monkeypatch, 2048)
    assert sum(counts.values()) == 132 - 12  # the 5 Grams, 5 F S and 2 TV launches are the loss's
    got = {(k, shape): n for (_, k, shape), n in counts.items() if k.startswith("conv1x1")}
    assert got == {key: n for key, (n, _) in STEP_2048_CONV1X1.items()}
    assert sum(got.values()) == 80
    for (kernel, shape), (_, width) in STEP_2048_CONV1X1.items():
        if kernel == "conv1x1_fwd":
            assert _launch.conv1x1_width(shape[3]) == width, shape
        else:
            assert _launch.conv1x1_width(shape[3], shape[6]) == width, shape
    widths = [w for n, w in STEP_2048_CONV1X1.values() for _ in range(n)]
    assert (widths.count(64), widths.count(128)) == (35, 45)


@pytest.mark.parametrize("n, gate, width", [
    (64, False, 64), (72, False, 128), (128, False, 128), (136, False, 64), (152, False, 64),
    (256, False, 128), (256, True, 64), (2048, True, 64), (4608, False, 128)])
def test_conv1x1_width_rule(n, gate, width):
    assert _launch.conv1x1_width(n, gate) == width
    assert width in _launch.CONV1X1_WIDTHS


@pytest.mark.parametrize("k, n, stride, match", [
    (60, 64, 1, "multiples of 8"), (64, 100, 1, "multiples of 8"), (32, 64, 1, "at least 64"),
    (64, 56, 1, "at least 64"), (64, 64, 3, "stride 1 or 2")])
def test_conv1x1_launcher_refuses_what_the_kernel_does_not_take(monkeypatch, k, n, stride, match):
    """The launcher raises before the library is reached, with no fallback."""
    monkeypatch.setattr(_launch, "_require", lambda *args, **kwargs: None)
    monkeypatch.setattr(_launch, "library", lambda: pytest.fail("the library was reached"))
    x = torch.empty(16, 16, k, dtype=torch.bfloat16, device="meta")
    w = torch.empty(k, n, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=match):
        _launch.conv1x1_fwd(x, w, torch.empty(n, dtype=torch.bfloat16, device="meta"),
                            stride=stride, count=RK.launches)
