"""Single-price allocator core (paper §4.3, Algorithm 1).

With one global budget the Lagrangian dual is a scalar price lambda and
the inner max decomposes per request:

    x_ij = 1  iff  j = argmax_j (R_ij - lambda * c_j)          (Eq. 10)

``allocate`` makes those decisions, ``consumption`` prices a window at
a given lambda, and ``dual_descent`` runs Algorithm 1's projected
subgradient steps on the device: a fixed number of iterations with no
host read inside, so the nearline update never blocks the response.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DualDescentConfig:
    max_iters: int = 200  # L in Algorithm 1
    step_size: float = 1.0  # eta (normalized internally, see below)
    step_decay: float = 0.999


def allocate(rewards, costs, lam):
    """Eq. 10: rewards (I, J), costs (J,), scalar lam -> (I,) int32."""
    score = rewards - lam * costs[None, :]
    return torch.argmax(score, dim=1).to(torch.int32)


def consumption(rewards, costs, lam, mask=None):
    """Total spend if ``lam`` is the dual price; mask (I,) zeroes
    padded requests."""
    taken = costs[allocate(rewards, costs, lam).long()]
    return torch.sum(taken if mask is None else taken * mask)


def dual_descent(rewards, costs, budget, lam0, *, mask=None,
                 max_iters: int = 200, step_size: float = 1.0,
                 step_decay: float = 0.999):
    """Algorithm 1 inner loop (steps 5-9), vectorized over requests.

    The raw subgradient has the scale of the budget while useful prices
    have the scale of reward per unit cost, so the step is normalized by
    n * mean(cost)^2 (n = valid requests, floored at 1 so an empty
    window cannot slam the price to 0).  Returns (lam, gaps (L,)) as
    device tensors.  ``budget`` and ``lam0`` are numbers or device
    tensors; numbers enter by fill kernels, never by a host copy, so a
    CUDA graph can capture the whole loop."""
    costs = costs.to(torch.float32)
    rewards = rewards.to(torch.float32)
    dev = rewards.device
    f32 = torch.float32

    def scalar(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=f32)
        return torch.full((), float(x), dtype=f32, device=dev)

    if mask is None:
        n_eff = scalar(rewards.shape[0])
    else:
        n_eff = torch.sum(mask.to(f32))
    norm = torch.clamp(n_eff, min=1.0) * torch.mean(costs) ** 2 + 1e-30
    budget = scalar(budget)
    lam = scalar(lam0).clone()
    eta = scalar(step_size)
    gaps = []
    for _ in range(max_iters):
        gap = budget - consumption(rewards, costs, lam, mask)
        lam = torch.clamp(lam - eta * gap / norm, min=0.0)
        eta = eta * step_decay
        gaps.append(gap)
    trace = torch.stack(gaps) if gaps else torch.zeros(0, device=dev)
    return lam, trace
