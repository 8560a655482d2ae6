"""The closed-form model FLOPs against a count of the reference's own
operations at VGG-19's shapes, and VGG-19's counts pinned to the values the
harness read before the count took the architecture from the
configuration."""

import pytest
from torch.utils.flop_counter import FlopCounterMode

from stbench import flops, inputs, manifest
from stbench.reference import resize as R
from stbench.reference.objective import Objective

CELL = manifest.load_cell("adam-2048")
VGG19, FIELDS = CELL.arch, CELL.stylize()

# (flops_per_eval, bytes_per_eval) before the change, by (H, W)
PINNED = {(64, 48): (4651745280.0, 6033408.0),
          (256, 256): (99237232640.0, 128712704.0),
          (512, 512): (396948930560.0, 514850816.0),
          (1024, 1024): (1587795722240.0, 2059403264.0),
          (2048, 2048): (6351182888960.0, 8237613056.0)}


def _counts(hw):
    params = VGG19.weights(1, "cpu", CELL.config)
    obj = Objective(VGG19, params, inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, FIELDS)
    img = R.from_u8(inputs.image(1, 0, hw, "cpu"))
    targets = obj.targets(img, img)
    with FlopCounterMode(display=False) as counter:
        obj.value_and_grad(img, targets)
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    return by_op


def test_closed_form_equals_the_count_at_vgg19_shapes():
    hw = (64, 48)
    by_op = _counts(hw)
    conv_fwd = by_op["aten.convolution"]
    conv_bwd = by_op["aten.convolution_backward"]
    # the convolutions to conv5_1, forward and input-gradient backward
    gram = sum(2.0 * (hw[0] >> b) * (hw[1] >> b) * c * c for b, c in enumerate((64, 128, 256, 512, 512)))
    assert conv_fwd == conv_bwd
    assert flops.flops_per_eval(VGG19, FIELDS, hw) == 2.0 * conv_fwd + 2.0 * gram
    # the Grams' forward products, and the two of each one's backward
    assert by_op["aten.mm"] == 3 * gram


def test_ladder_flops_and_peaks():
    scales = [((256, 256), 10), ((512, 512), 5)]
    assert flops.flops_per_ladder(VGG19, FIELDS, scales) == (
        10 * flops.flops_per_eval(VGG19, FIELDS, (256, 256))
        + 5 * flops.flops_per_eval(VGG19, FIELDS, (512, 512)))
    # the 2048 px step's count the port's own bench quoted: 6.35 TFLOP
    assert abs(flops.flops_per_eval(VGG19, FIELDS, (2048, 2048)) / 1e12 - 6.351) < 0.01
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert flops.peaks("cpu") == {}
    # the byte bound lies below the FLOP bound at these shapes
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    hw = (512, 512)
    assert (flops.bytes_per_eval(VGG19, FIELDS, hw) / peak["hbm_bytes_per_s"]
            < flops.flops_per_eval(VGG19, FIELDS, hw) / peak["bf16_flops_per_s"])


@pytest.mark.parametrize("hw", sorted(PINNED))
def test_vgg19_counts_are_the_pinned_floats(hw):
    assert flops.flops_per_eval(VGG19, FIELDS, hw) == PINNED[hw][0]
    assert flops.bytes_per_eval(VGG19, FIELDS, hw) == PINNED[hw][1]


def test_the_ladder_cells_count_is_the_pinned_float():
    cell = manifest.load_cell("adam-ladder-2048")
    f = cell.stylize()
    scales = R.ladder(tuple(cell.workload["content_hw"]), int(f["size"]), f["iterations"],
                      min_scale=int(f["min_scale"]))
    assert scales == [((256, 256), 250), ((512, 512), 200), ((1024, 1024), 150),
                      ((2048, 2048), 100)]
    assert flops.flops_per_ladder(cell.arch, f, scales) == 977486741504000.0


def test_the_count_follows_the_configurations_layers():
    """Fewer or shallower layers count less: the forward stops at the
    deepest requested layer, and each style layer brings its own Gram."""
    hw = (256, 256)
    full = flops.flops_per_eval(VGG19, FIELDS, hw)
    shallow = {**FIELDS, "content_layers": ["conv2_2"], "style_layers": ["conv1_1", "conv2_1"]}
    convs, grams = flops.work(VGG19, shallow, hw)
    assert [c[:4] for c in convs] == [(256, 256, 3, 3)] * 2 + [(128, 128, 3, 3)] * 2
    assert grams == [(256, 256, 64), (128, 128, 128)]
    assert flops.flops_per_eval(VGG19, shallow, hw) < full
