"""The closed-form model FLOPs against a count of the reference's own
operations at VGG-19's shapes."""

from torch.utils.flop_counter import FlopCounterMode

from stbench import flops, inputs
from stbench.reference import resize as R
from stbench.reference.objective import Objective

STYLIZE = {"content_layers": ["conv4_2"],
           "style_layers": ["conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1"],
           "content_weight": 1.0, "style_weight": 256.0, "tv_weight": 2.0}


def _counts(hw):
    params = inputs.vgg19_weights(1, "cpu", 0.05)
    obj = Objective(params, inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, STYLIZE)
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
    assert flops.flops_per_eval(hw) == 2.0 * conv_fwd + 2.0 * gram
    # the Grams' forward products are the matrix products of the forward pass
    assert by_op["aten.mm"] >= gram


def test_ladder_flops_and_peaks():
    scales = [((256, 256), 10), ((512, 512), 5)]
    assert flops.flops_per_ladder(scales) == 10 * flops.flops_per_eval((256, 256)) + 5 * flops.flops_per_eval((512, 512))
    # the 2048 px step's count the port's own bench quoted: 6.35 TFLOP
    assert abs(flops.flops_per_eval((2048, 2048)) / 1e12 - 6.351) < 0.01
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert flops.peaks("cpu") == {}
    # the byte bound lies below the FLOP bound at these shapes
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    hw = (512, 512)
    assert flops.bytes_per_eval(hw) / peak["hbm_bytes_per_s"] < flops.flops_per_eval(hw) / peak["bf16_flops_per_s"]
