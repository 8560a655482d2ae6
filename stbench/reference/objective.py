"""The Gatys objective on any architecture, in plain float32 PyTorch.

The network is the configuration's architecture (``stbench/arch/<arch>.py``:
its ``prepare`` and ``features``), fed an NHWC float image in [0, 1]
normalized by the per-channel mean and standard deviation and laid out as
NCHW. The objective is ``content_weight * content + style_weight * style +
tv_weight * tv``: the content term is the mean squared error of the content
layers' activations against the content image's; the style term is the
mean squared error of the Gram matrices ``F^T F / (H W)`` of the style
layers against the style image's; each term's layers are weighted
uniformly (weights summing to one); TV is the sum of the squared forward
differences along H and W over the number of image elements.

Everything runs in float32 with TF32 off (:func:`fp32`). ``quant``, where
given, rounds every convolution's input, weights and output (the
architecture applies it) and every Gram's input through it, in the forward
and, for the activations, in the backward: the benchmark's control
computes the same objective in a lower precision this way (:func:`fp8`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0  # the largest float8_e4m3fn


@contextlib.contextmanager
def fp32():
    """Float32 matrix products and convolutions: TF32 off inside."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to the format's largest value), back in float32."""
    amax = x.detach().abs().amax()
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Scaled float8 e4m3 rounding of a tensor, and of its gradient."""
    return _Fp8.apply(x)


def gram(f: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (C, C) ``F^T F / (H W)``."""
    m = f.reshape(f.shape[1], -1)
    return (m @ m.T) / float(m.shape[1])


def tv_loss(image: torch.Tensor) -> torch.Tensor:
    """Squared differences of neighbouring pixels over the image's elements."""
    dh = image[:, 1:] - image[:, :-1]
    dw = image[:, :, 1:] - image[:, :, :-1]
    return (torch.sum(dh * dh) + torch.sum(dw * dw)) / float(image.numel())


def _device(params) -> torch.device:
    """The device of the first leaf of nested mappings of tensors."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class Objective:
    """The objective of one configuration on one set of weights.

    ``arch``: the architecture's module; ``params``: its weights as its
    ``weights`` draws them, nested mappings of tensors (any device);
    ``stylize``: the configuration's layers and weights (``content_layers``,
    ``style_layers``, ``content_weight``, ``style_weight``, ``tv_weight``)."""

    def __init__(self, arch, params, mean, std, stylize: dict,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.arch = arch
        self.net = arch.prepare(params, quant)
        device = _device(params)
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=device)
        self.content_layers = tuple(stylize["content_layers"])
        self.style_layers = tuple(stylize["style_layers"])
        self.cw = float(stylize["content_weight"])
        self.sw = float(stylize["style_weight"])
        self.tw = float(stylize["tv_weight"])
        self.q = quant or (lambda t: t)

    def features(self, image: torch.Tensor, layers: Sequence[str]) -> Dict[str, torch.Tensor]:
        """NCHW activations of ``layers`` for an NHWC image."""
        x = ((image - self.mean) / self.std).permute(0, 3, 1, 2)
        return self.arch.features(self.net, x, layers, self.q)

    @torch.no_grad()
    def targets(self, content: torch.Tensor, style: torch.Tensor):
        """Content activations of ``content`` and style Grams of ``style``
        (NHWC images already at their sizes)."""
        c = self.features(content, self.content_layers)
        s = self.features(style, self.style_layers)
        return {l: c[l] for l in self.content_layers}, {l: gram(self.q(s[l]))
                                                        for l in self.style_layers}

    def terms(self, image: torch.Tensor, targets) -> Dict[str, torch.Tensor]:
        c_t, s_t = targets
        feats = self.features(image, self.content_layers + self.style_layers)
        content = sum(torch.mean(torch.square(feats[l] - c_t[l])) for l in self.content_layers)
        style = sum(torch.mean(torch.square(gram(self.q(feats[l])) - s_t[l]))
                    for l in self.style_layers)
        content = content / len(self.content_layers)
        style = style / len(self.style_layers)
        tv = tv_loss(image)
        loss = self.cw * content + self.sw * style + self.tw * tv
        return {"loss": loss, "content": content, "style": style, "tv": tv}

    def value_and_grad(self, image: torch.Tensor, targets) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loss (a 0-d tensor) and its gradient by the image."""
        with torch.enable_grad():
            x = image.detach().to(torch.float32).requires_grad_(True)
            loss = self.terms(x, targets)["loss"]
            (g,) = torch.autograd.grad(loss, (x,))
        return loss.detach(), g
