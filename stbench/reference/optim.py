"""Adam on an image, in plain PyTorch, for the benchmark's reference.

Adam is optax's: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
the step ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with both moments
bias-corrected by the step count. It starts from a fresh state or from a
given one (``count``, ``mu``, ``nu``: the leaves of optax's
``ScaleByAdamState``, as a progress event's ``get_state`` gives them).
"""

from __future__ import annotations

from typing import Optional

import torch


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
                 count: int = 0, mu: Optional[torch.Tensor] = None,
                 nu: Optional[torch.Tensor] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count, self.mu, self.nu = count, mu, nu

    def step(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.mu is None:
            self.mu, self.nu = torch.zeros_like(x), torch.zeros_like(x)
        self.count += 1
        self.mu = (1.0 - self.b1) * g + self.b1 * self.mu
        self.nu = (1.0 - self.b2) * g * g + self.b2 * self.nu
        mu_hat = self.mu / (1.0 - self.b1 ** self.count)
        nu_hat = self.nu / (1.0 - self.b2 ** self.count)
        return x - self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
