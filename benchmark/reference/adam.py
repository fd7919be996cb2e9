"""The optimizer of the ``fit`` traffic, written out: torch.optim.Adam's
update for one parameter tensor, started from zero moments or from a
given state."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Adam:
    """Adam with betas (0.9, 0.999), eps 1e-8, no weight decay; ``m``,
    ``v`` and ``step_count`` are the state before the next step."""

    lr: float
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    step_count: int = 0
    m: torch.Tensor | None = None
    v: torch.Tensor | None = None

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """-> the parameter after one step with ``grad``."""
        if self.m is None:
            self.m, self.v = torch.zeros_like(param), torch.zeros_like(param)
        self.step_count += 1
        self.m = self.beta1 * self.m + (1.0 - self.beta1) * grad
        self.v = self.beta2 * self.v + (1.0 - self.beta2) * grad * grad
        m_hat = self.m / (1.0 - self.beta1 ** self.step_count)
        v_hat = self.v / (1.0 - self.beta2 ** self.step_count)
        return param - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
