"""Image-domain optimizer: Adam with optax semantics (PyTorch port).

Counterpart of ``style_transfer_tpu/optim.py``. Adam is written out as
``optax.adam`` computes it — ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 +
b2 nu``, bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)`` with eps outside
the square root, scaled by ``-lr``, no clipping of the image — rather than
through ``torch.optim.Adam``, so the two packages take the same steps.

``make_chunk_fn`` is a Python loop over steps (the JAX ``lax.scan``); the
host reads the stacked per-step losses once per chunk.

L-BFGS (``optax.lbfgs`` with the zoom line search) is not ported yet: see
ROADMAP.md, queue 1, "L-BFGS".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

ObjectiveFn = Callable[[torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Optimizer selection; only ``"adam"`` is ported."""

    name: str = "adam"
    learning_rate: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def build(self) -> "Adam":
        if self.name == "adam":
            return Adam(self.learning_rate, self.beta1, self.beta2, self.eps)
        if self.name == "lbfgs":
            raise NotImplementedError(
                "L-BFGS is not ported to style_transfer_tpu_torch yet "
                "(ROADMAP.md, queue 1: L-BFGS)"
            )
        raise ValueError(f"unknown optimizer {self.name!r} (expected 'adam' or 'lbfgs')")


@dataclasses.dataclass
class AdamState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class Adam:
    """``optax.adam`` on one tensor, state in :class:`AdamState`."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, image: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(image), torch.zeros_like(image))

    @torch.no_grad()
    def update(self, grad: torch.Tensor, state: AdamState, image: torch.Tensor):
        """Returns (new image, new state); inputs are not modified."""
        mu = (1.0 - self.b1) * grad + self.b1 * state.mu
        nu = (1.0 - self.b2) * (grad * grad) + self.b2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1.0 - self.b1 ** count)
        nu_hat = nu / (1.0 - self.b2 ** count)
        step = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return image + step, AdamState(count, mu, nu)


def make_step_fn(objective: ObjectiveFn, spec: OptimizerSpec):
    """``step(image, state) -> (image, state, aux)``: value and gradient of
    ``objective`` by autograd, then one optimizer update."""
    optimizer = spec.build()

    def step(image, state):
        x = image.detach().requires_grad_(True)
        loss, aux = objective(x)
        (grad,) = torch.autograd.grad(loss, x)
        image, state = optimizer.update(grad, state, image)
        return image, state, {k: v.detach() for k, v in aux.items()}

    return step, optimizer


def make_chunk_fn(step, chunk_size: int):
    """``chunk_size`` steps in a loop; per-step loss terms stacked on the
    device (``{term: (chunk_size,)}``) for one host read per chunk."""

    def run_chunk(image, state):
        rows = []
        for _ in range(chunk_size):
            image, state, aux = step(image, state)
            rows.append(aux)
        losses = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return image, state, losses

    return run_chunk
