"""style_transfer_tpu_torch — the PyTorch / CUDA port of style_transfer_tpu.

The JAX package (``style_transfer_tpu``) stays the reference; this package
mirrors its module names and public layouts (NHWC activations, HWIO kernels,
``{layer: {"kernel", "bias"}}`` params) so each counterpart is easy to find
and the two can be compared like with like. The TPU's Pallas kernels on the
default ``stylize()`` path are hand-written CUDA kernels for Hopper
(``csrc/``, built with ``nvcc`` at first use); on CPU tensors every kernel
wrapper runs its plain PyTorch version. This package never imports JAX.
"""

__version__ = "0.1.0"

from style_transfer_tpu_torch.api import StyleTransfer, StylizeConfig  # noqa: F401
from style_transfer_tpu_torch.models.vgg import VGG, VGG19, LAYER_NAMES  # noqa: F401

__all__ = ["StyleTransfer", "StylizeConfig", "VGG", "VGG19", "LAYER_NAMES", "__version__"]
