"""Plain AdamW (decoupled weight decay, bias-corrected moments), fp32."""

from __future__ import annotations

from typing import Dict

import torch


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas, eps: float, weight_decay: float):
        self.params = params
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)

    def first_moment(self, name: str) -> torch.Tensor:
        return self.m[name]
