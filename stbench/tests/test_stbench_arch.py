"""Architectures found by a configuration's ``arch``: VGG-19's weight draw
pinned to the bits the harness drew before the draw moved into
``stbench/arch/vgg19.py``, and a toy network with a residual network's
shapes (a 1x1 convolution, a stride-2 3x3, a residual add, a max pool),
defined by files alone in a new root, found, counted and judged through
them."""

import hashlib
import json
from pathlib import Path

import pytest
from torch.utils.flop_counter import FlopCounterMode

from stbench import flops, inputs, manifest
from stbench.capture import Capture, State
from stbench.judge import NUMBERS, _adam, follow, judge, passes
from stbench.reference import resize as R
from stbench.reference.objective import Objective, fp32, tv_loss
from stbench.tests.conftest import REPO

# seed: (sha256 of every leaf's bytes in sorted name order, kernel then
# bias; the float64 sum; four entries), drawn on the CPU before the change
PINNED = {
    1: ("ae8ced4503325274c95df6d24b194d8f9a0a84eeebd1bd9365450c2af333ae76", -80.03882614077479,
        0.361642450094223, 0.053559351712465286, 0.1211615726351738, -0.040010806173086166),
    3: ("643bd04724fd69a8bddfd774d0a936f004b4974930245e47d88d489f6177ce6b", -10.618776026296565,
        -0.4124278128147125, 0.005920696537941694, -0.004077955614775419, -0.03850163146853447),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_vgg19_weights_are_the_pinned_draw(seed):
    cell = manifest.load_cell("adam-2048")
    assert cell.config["arch"] == "vgg19" and cell.arch.__name__ == "stbench_arch_vgg19"
    p = cell.arch.weights(seed, "cpu", cell.config)
    digest = hashlib.sha256()
    for name in sorted(p):
        for leaf in ("kernel", "bias"):
            digest.update(p[name][leaf].contiguous().numpy().tobytes())
    sha, total, k11, k34, b54, b21 = PINNED[seed]
    assert digest.hexdigest() == sha
    assert float(sum(p[n][l].double().sum() for n in p for l in ("kernel", "bias"))) == \
        pytest.approx(total, rel=1e-12)
    assert float(p["conv1_1"]["kernel"][1, 2, 0, 5]) == k11
    assert float(p["conv3_4"]["kernel"][0, 1, 200, 17]) == k34
    assert float(p["conv5_4"]["bias"][511]) == b54
    assert float(p["conv2_1"]["bias"][3]) == b21


def test_vgg19_refuses_a_configuration_of_other_shapes():
    cell = manifest.load_cell("adam-2048")
    for change in ({"widths": [64, 128, 256, 512, 256]}, {"convs_per_block": [2, 2, 3, 3, 3]},
                   {"program": {"pooling": "max"}}):
        with pytest.raises(ValueError, match="states"):
            cell.arch.weights(1, "cpu", {**cell.config, **change})


TOY = '''"""A toy network with a residual network's shapes: a 3x3 stem, a 3x3
stride-2 max pool, and one bottleneck (1x1, 3x3 of stride 2, 1x1) whose
sum with a 1x1 stride-2 projection shortcut is the layer ``block1``."""

import torch
import torch.nn.functional as F

from stbench.inputs import weights_generator

# name: (kh, kw, cin, cout, stride)
CONVS = {"stem": (3, 3, 3, 8, 1), "reduce": (1, 1, 8, 4, 1), "mid": (3, 3, 4, 4, 2),
         "expand": (1, 1, 4, 16, 1), "shortcut": (1, 1, 8, 16, 2)}


def weights(seed, device, config):
    sizes = [kh * kw * ci * co for kh, kw, ci, co, _ in CONVS.values()]
    flat = torch.randn(sum(sizes), generator=weights_generator(seed, device), device=device)
    out, o = {}, 0
    for (name, (kh, kw, ci, co, _)), n in zip(CONVS.items(), sizes):
        out[name] = {"kernel": flat[o:o + n].view(co, ci, kh, kw) * (2.0 / (kh * kw * ci)) ** 0.5}
        o += n
    return out


def prepare(params, quant=None):
    q = quant or (lambda t: t)
    return {n: q(params[n]["kernel"].detach().to(torch.float32)) for n in CONVS}


def _conv(prepared, name, x, q):
    kh, _, _, _, stride = CONVS[name]
    return q(F.conv2d(q(x), prepared[name], stride=stride, padding=kh // 2))


def features(prepared, x, layers, q):
    out = {"stem": torch.relu(_conv(prepared, "stem", x, q))}
    if "block1" in layers:
        x = F.max_pool2d(out["stem"], 3, stride=2, padding=1)
        y = torch.relu(_conv(prepared, "reduce", x, q))
        y = _conv(prepared, "expand", torch.relu(_conv(prepared, "mid", y, q)), q)
        out["block1"] = torch.relu(y + _conv(prepared, "shortcut", x, q))
    return {l: out[l] for l in layers}


def _half(n):
    return (n - 1) // 2 + 1


def work(hw, content_layers, style_layers):
    h, w = hw
    convs, shape = [(h, w, 3, 3, 3, 8)], {"stem": (h, w, 8)}
    if "block1" in set(content_layers) | set(style_layers):
        h, w = _half(h), _half(w)
        h2, w2 = _half(h), _half(w)
        convs += [(h, w, 1, 1, 8, 4), (h2, w2, 3, 3, 4, 4), (h2, w2, 1, 1, 4, 16),
                  (h2, w2, 1, 1, 8, 16)]
        shape["block1"] = (h2, w2, 16)
    return convs, [shape[l] for l in style_layers]
'''

TOY_CONFIG = {
    "name": "toy-net", "source": "a toy residual network", "arch": "toy", "reduced": [],
    "stylize": {"content_layers": ["block1"], "style_layers": ["stem", "block1"],
                "content_weight": 1.0, "style_weight": 256.0, "tv_weight": 2.0,
                "init": "content", "use_fused": True, "stop_tol": 0.0,
                "optimizer": {"name": "adam", "learning_rate": 0.05}},
}


@pytest.fixture
def toy_root(tmp_path):
    """A root whose one cell's configuration names ``arch`` ``toy``: new
    files and entries only."""
    (tmp_path / "stbench" / "arch").mkdir(parents=True)
    (tmp_path / "stbench" / "configs").mkdir()
    (tmp_path / "stbench" / "workloads").mkdir()
    (tmp_path / "stbench" / "arch" / "toy.py").write_text(TOY)
    (tmp_path / "stbench" / "configs" / "toy-net.json").write_text(json.dumps(TOY_CONFIG))
    wl = {"config": "toy-net", "loop": "steady", "content_hw": [17, 12], "style_hw": [12, 16],
          "stylize": {"size": 17, "min_scale": 17, "chunk_size": 4}, "why": "toy",
          "limits": {"start_tv": 1e-5, "end_loss": 0.25, "end_change": 0.3, "output": 0}}
    (tmp_path / "stbench" / "workloads" / "toy-adam.json").write_text(json.dumps(wl))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": "toy-net", "source": "toy", "file": "stbench/configs/toy-net.json",
                     "reduced": [], "why": "toy"}]
    b["workloads"] = [{"name": "toy-adam", "config": "toy-net", "traffic": "toy-adam",
                       "chips": 1, "why": "toy"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path


def test_a_new_architecture_is_found_through_its_configuration(toy_root):
    cell = manifest.load_cell("toy-adam", toy_root)
    toy = (toy_root / "stbench" / "arch" / "toy.py").resolve()
    assert Path(cell.arch.__file__).resolve() == toy
    assert set(cell.arch.CONVS) == {"stem", "reduce", "mid", "expand", "shortcut"}
    # a configuration that names an architecture with no file
    path = toy_root / "stbench" / "configs" / "toy-net.json"
    path.write_text(json.dumps({**TOY_CONFIG, "arch": "absent"}))
    with pytest.raises(FileNotFoundError, match="absent.py"):
        manifest.load_cell("toy-adam", toy_root)
    with pytest.raises(ValueError, match="not a name"):
        manifest.load_arch("../toy", toy_root)


def _setup(root, seed=5):
    cell = manifest.load_cell("toy-adam", root)
    fields = cell.stylize()
    params = cell.arch.weights(seed, "cpu", cell.config)
    content, style = inputs.images(seed, 0, cell.workload["content_hw"],
                                   cell.workload["style_hw"], "cpu")
    return cell, fields, params, content, style


@pytest.mark.parametrize("layers", [(["block1"], ["stem", "block1"]), (["stem"], ["stem"])])
def test_the_toys_work_is_its_references_count(toy_root, layers):
    cell, fields, params, content, _ = _setup(toy_root)
    fields = {**fields, "content_layers": layers[0], "style_layers": layers[1]}
    hw = tuple(cell.workload["content_hw"])
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
    assert flops.bytes_per_eval(cell.arch, fields, hw) == 2.0 * 2 * sum(
        ho * wo * (ci + co) for ho, wo, _, _, ci, co in convs)


def _reference_capture(cell, fields, params, content, style, iterations):
    """What a program that is the reference itself would report for one
    scale of ``iterations`` Adam steps at the content's size."""
    hw = tuple(cell.workload["content_hw"])
    cap = Capture([(hw, iterations)], int(fields["chunk_size"]))
    with fp32():
        obj = Objective(cell.arch, params, inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, fields)
        c01, s01 = R.from_u8(content), R.from_u8(style)
        tg = obj.targets(R.resize(c01, hw), R.resize(s01, R.style_size(tuple(style.shape[:2]), hw)))
        x = R.resize(c01, hw)
        cap.first_tv[hw] = float(tv_loss(x))
        adam = _adam(fields["optimizer"])
        last = cap.last_len(iterations)
        _, x = follow(obj, tg, adam, x, iterations - last)
        cap.before[hw] = State(x, adam.count, adam.mu, adam.nu)
        cap.last[hw], x = follow(obj, tg, adam, x, last)
        cap.end[hw] = State(x, adam.count, adam.mu, adam.nu)
    cap.result = R.quantize(x)
    return cap


def test_the_judge_reads_the_toys_own_reference_as_sound(toy_root):
    cell, fields, params, content, style = _setup(toy_root)
    limits = cell.workload["limits"]
    cap = _reference_capture(cell, fields, params, content, style, iterations=6)
    assert cap.before[tuple(cell.workload["content_hw"])].count == 4
    numbers = judge(cell.arch, fields, cap, content, style, params, inputs.IMAGENET_MEAN,
                    inputs.IMAGENET_STD, "cpu")
    assert numbers == dict.fromkeys(NUMBERS, 0.0) and passes(numbers, limits)
    # the same steps with the last chunk's image left where it started
    hw = tuple(cell.workload["content_hw"])
    cap.end[hw] = State(cap.before[hw].image, 6, cap.end[hw].mu, cap.end[hw].nu)
    cap.result = R.quantize(cap.before[hw].image)
    frozen = judge(cell.arch, fields, cap, content, style, params, inputs.IMAGENET_MEAN,
                   inputs.IMAGENET_STD, "cpu")
    assert frozen["end_change"] == pytest.approx(1.0) and not passes(frozen, limits)


def test_the_arch_files_alone_name_vgg19():
    """No code of the harness outside ``arch/vgg19.py`` names VGG-19's layers
    or its weight draw: it reaches the architecture through ``arch``."""
    names = ("BLOCKS", "CONV_NAMES", "vgg19_weights", "conv1_1", "conv4_2", "conv5_1")
    for path in (REPO / "stbench").rglob("*.py"):
        rel = path.relative_to(REPO / "stbench").as_posix()
        if rel == "arch/vgg19.py" or rel.startswith("tests/"):
            continue
        text = path.read_text()
        assert not [n for n in names if n in text], rel

