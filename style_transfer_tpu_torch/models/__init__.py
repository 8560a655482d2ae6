"""The port's networks: VGG-19 and VGG-16 (``vgg.py``), ResNet-50
(``resnet.py``)."""

from typing import Mapping


def infer_arch(params: Mapping[str, object]) -> str:
    """Which supported architecture a parameter dict belongs to, by its key
    set: ``resnet50``, or one of ``vgg.ARCH_BLOCKS``."""
    from style_transfer_tpu_torch.models import resnet, vgg

    if resnet.matches(params):
        return resnet.ARCH
    try:
        return vgg.infer_arch(params)
    except ValueError:
        raise ValueError(
            f"parameter keys match no supported arch {sorted(vgg.ARCH_BLOCKS) + [resnet.ARCH]}: "
            f"{sorted(params.keys())[:6]}..."
        ) from None
