"""ResNet-50's configuration (``configs/resnet50-gatys-adam.json``,
``arch/resnet50.py``): its model work against PyTorch's FLOP counter on
its own reference, its weights pinned, the launch-shape work of the 1x1
GEMM (``launch_work.py``) and its roofline reader, and a tiny cell of the
configuration on the CPU judged ``correct``, with planted faults failing
it."""

import hashlib
import json

import pytest
from torch.utils.flop_counter import FlopCounterMode

from stbench import faults, flops, inputs, launch_work, manifest
from stbench.reference import resize as R
from stbench.reference.objective import Objective
from stbench.tests.conftest import REPO, make_root, run_cell

CELL = "resnet50-adam-2048"

# seed: (sha256 of every leaf's bytes in sorted name order, kernel then
# bias; the float64 sum; four entries), drawn on the CPU
PINNED = {
    1: ("90bf8efd905bcc6c96bf8263700d9e32322537421e5f3048c0500737e7afdf43", -135.96215828035298,
        0.05628737062215805, -0.02610674500465393, 0.09547197073698044, -0.015987273305654526),
    3: ("2fd6ace575be8121db3cfe9521e3546fee255b0dd985f1cdcf42f4305099803d", -12.650480782762124,
        -0.14771363139152527, 0.00951322354376316, -0.04685236141085625, -0.01810184307396412),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_resnet50_weights_are_the_pinned_draw(seed):
    cell = manifest.load_cell(CELL)
    assert cell.config["arch"] == "resnet50"
    p = cell.arch.weights(seed, "cpu", cell.config)
    assert len(p) == 53
    digest = hashlib.sha256()
    for name in sorted(p):
        for leaf in ("kernel", "bias"):
            digest.update(p[name][leaf].contiguous().numpy().tobytes())
    sha, total, k1, k332, b40d, b212 = PINNED[seed]
    assert digest.hexdigest() == sha
    assert float(sum(p[n][l].double().sum() for n in p for l in ("kernel", "bias"))) == \
        pytest.approx(total, rel=1e-12)
    assert float(p["conv1"]["kernel"][3, 2, 1, 5]) == k1
    assert float(p["layer3.2.conv3"]["kernel"][0, 0, 100, 900]) == k332
    assert float(p["layer4.0.downsample"]["bias"][2047]) == b40d
    assert float(p["layer2.1.conv2"]["bias"][7]) == b212


def test_resnet50_refuses_a_configuration_of_other_shapes():
    cell = manifest.load_cell(CELL)
    for change in ({"widths": [64, 128, 256, 256]}, {"blocks": [3, 4, 23, 3]},
                   {"expansion": 2}, {"program": {"pooling": "average"}}):
        with pytest.raises(ValueError, match="states"):
            cell.arch.weights(1, "cpu", {**cell.config, **change})


@pytest.mark.parametrize("hw, layers", [((40, 36), None), ((33, 21), (["layer1"], ["conv1"]))])
def test_the_work_is_the_references_count(hw, layers):
    cell = manifest.load_cell(CELL)
    fields = cell.stylize()
    if layers:
        fields = {**fields, "content_layers": layers[0], "style_layers": layers[1]}
    params = cell.arch.weights(5, "cpu", cell.config)
    content, _ = inputs.images(5, 0, hw, hw, "cpu")
    obj = Objective(cell.arch, params, inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, fields)
    img = R.from_u8(content)
    targets = obj.targets(img, img)
    with FlopCounterMode(display=False) as counter:
        obj.value_and_grad(img, targets)
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    convs, grams = flops.work(cell.arch, fields, hw)
    conv = sum(2 * ho * wo * kh * kw * ci * co for ho, wo, kh, kw, ci, co in convs)
    gram = sum(2 * h * w * c * c for h, w, c in grams)
    assert by_op["aten.convolution"] == by_op["aten.convolution_backward"] == conv
    assert by_op["aten.mm"] == 3 * gram
    assert flops.flops_per_eval(cell.arch, fields, hw) == 2.0 * conv + 2.0 * gram


def test_the_cells_model_work_is_pinned():
    cell = manifest.load_cell(CELL)
    fields = cell.stylize()
    convs, grams = flops.work(cell.arch, fields, (2048, 2048))
    assert len(convs) == 53 and grams[-1] == (64, 64, 2048)
    assert flops.flops_per_eval(cell.arch, fields, (2048, 2048)) == 1658662682624.0
    assert flops.bytes_per_eval(cell.arch, fields, (2048, 2048)) == 6715080704.0
    assert flops.flops_per_eval(cell.arch, fields, (64, 48)) == 1289289728.0


def test_the_gemm_launches_work_is_pinned():
    # stage 2's stride-2 projection: 256^2 outputs read at the pixels they sample
    assert launch_work.conv1x1("conv1x1_fwd", (512, 512, 256, 512, 2, False, False)) == \
        (17179869184.0, 2.0 * (65536 * 256 + 256 * 512 + 65536 * 512 + 512))
    # stage 4's expansion with its residual
    assert launch_work.conv1x1("conv1x1_fwd", (64, 64, 512, 2048, 1, True, True)) == \
        (8589934592.0, 2.0 * (4096 * 512 + 512 * 2048 + 2 * 4096 * 2048 + 2048))
    # stage 2's head, backward: the projection's cotangent added on the even pixels
    assert launch_work.conv1x1("conv1x1_bwd_data", (512, 512, 128, 256, True, True, False)) == \
        (17179869184.0, 2.0 * (262144 * 128 + 128 * 256 + 262144 * 256 + 65536 * 256))
    assert launch_work.conv1x1("conv1x1_bwd_data", (5, 3, 64, 64, False, False, True)) == \
        (2.0 * 15 * 64 * 64, 2.0 * (15 * 64 + 64 * 64 + 2 * 15 * 64))
    with pytest.raises(ValueError):
        launch_work.conv1x1("conv3x3_fwd", ())
    assert launch_work.hbm_bytes_per_s(989e12) == 3.35e12
    assert launch_work.hbm_bytes_per_s(1.0) is None


def test_the_roofline_reader(monkeypatch):
    from style_transfer_tpu_torch import trace

    read = manifest.metric_reader("conv1x1_roofline_pct.steady")
    shape = (512, 512, 256, 64, 1, False, True)
    counts = {("resnet", "conv1x1_fwd", shape): 10, ("conv_single", "conv3x3_fwd", ()): 5}
    flops_, nbytes = launch_work.conv1x1("conv1x1_fwd", shape)
    least = 10 * max(flops_ / 989e12, nbytes / 3.35e12)
    ops = {"(anonymous namespace)::conv1x1_kernel(GemmArgs, CUtensorMap_st)": 4 * least,
           "conv3x3_wgmma_kernel": 1.0}
    run = {"loop": "steady", "peak_flops": 989e12, "slice": {"iterations": 100,
                                                             "device_op_s": ops}}
    monkeypatch.setattr(trace, "counts", lambda: counts)
    assert read(run) == pytest.approx(25.0)
    monkeypatch.setattr(trace, "counts", lambda: {("conv_single", "conv3x3_fwd", ()): 5})
    assert read(run) is None  # a program without the kernel: nothing to read
    assert read({**run, "peak_flops": None}) is None
    assert read({"loop": "ladder"}) is None


def test_the_cell_is_in_the_benchmark_as_new_entries():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in b["workloads"] if w["name"] == CELL)
    assert cell["config"] == "resnet50-gatys-adam" and cell["chips"] == 1
    lists = {m["name"]: m.get("workloads") for m in b["end_to_end"] + b["per_layer"]}
    for name in ("its_per_s", "mfu_pct.steady", "device_idle_pct.steady",
                 "launches_per_it.steady", "kernel_launches_per_it.steady",
                 "conv1x1_roofline_pct.steady"):
        assert CELL in lists[name], name
    assert CELL not in lists["kernel_roofline_pct.steady"]  # its bound is FLOPs alone
    config = manifest.load_cell(CELL).config
    assert config["reduced"] == [] and config["widths"] == [64, 128, 256, 512]


@pytest.fixture(scope="module")
def resnet_root(tmp_path_factory):
    """A root with a tiny cell of the configuration, under the limits of
    the calibrated cell."""
    root = make_root(tmp_path_factory.mktemp("stbench_resnet"))
    real = json.loads((REPO / "stbench" / "workloads" / f"{CELL}.json").read_text())
    wl = {"config": real["config"], "why": "tiny", "limits": real["limits"], "loop": "steady",
          "content_hw": [32, 24], "style_hw": [24, 32],
          "stylize": {"size": 32, "min_scale": 32, "chunk_size": 4}}
    (root / "stbench" / "workloads" / "tiny-resnet.json").write_text(json.dumps(wl))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny-resnet", "config": real["config"],
                           "traffic": "tiny-resnet", "chips": 1, "why": "tiny"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-resnet")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_a_tiny_cell_is_correct(resnet_root, capsys):
    result = run_cell(resnet_root, "tiny-resnet", capsys)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"its_per_s", "peak_mib", "setup_s"}
    for name, (value, _) in result["checks"].items():
        assert value <= (0 if name == "output" else 1e-4), (name, value)


@pytest.mark.parametrize("fault", ["unchanged", "freeze_late", "half_rows", "output"])
def test_a_broken_timed_path_is_not_correct(resnet_root, capsys, fault):
    chunk = manifest.load_cell("tiny-resnet", resnet_root).stylize()["chunk_size"]
    with faults.plant(fault, chunk):
        result = run_cell(resnet_root, "tiny-resnet", capsys)
    assert result["correct"] is False, result["checks"]
