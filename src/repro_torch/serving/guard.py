"""Budget downgrade guard: the tail-reserve rule, loop-free on tensors.

Walking the window in arrival order, request i keeps its allocated
option only if

    spend_so_far(i) + c_{m(i)} + c_min * (#requests after i)  <=  B

i.e. its own cost plus a cheapest-option reservation for everyone behind
it still fits; otherwise it is forced onto the cheapest option.  This
guarantees spend <= B whenever n * c_min <= B, and spend <= n * c_min
otherwise.  Downgrading lowers later prefix sums, which can un-trip
requests, so the rule is iterated a fixed ``GUARD_PASSES`` times (extra
passes are no-ops once nothing is over).

  * ``downgrade_guard``     - f32 cumsum form on the device, mask-aware
    for padded windows, one budget;
  * ``downgrade_guard_np``  - the NumPy float64 host form.

``downgraded`` counts requests whose final decision differs from the
allocator's.
"""
from __future__ import annotations

import numpy as np
import torch

GUARD_PASSES = 4


def downgrade_guard_np(decisions: np.ndarray, costs: np.ndarray,
                       budget: float, cheap: int,
                       *, passes: int = GUARD_PASSES):
    """Host guard (NumPy float64): decisions (n,) in arrival order,
    costs (J,), cheap the cheapest chain -> (decisions, downgraded,
    spend)."""
    decisions = np.asarray(decisions).copy()
    costs = np.asarray(costs)
    n = len(decisions)
    if n == 0:
        return decisions, 0, 0.0
    orig = decisions.copy()
    c_min = costs[cheap]
    spend = np.cumsum(costs[decisions])
    if spend[-1] > budget:
        kept_prefix = np.concatenate([[0.0], spend[:-1]])
        reserve = c_min * (n - 1 - np.arange(n))
        for _ in range(passes):
            over = kept_prefix + costs[decisions] + reserve > budget
            if not over.any():
                break
            decisions = np.where(over, cheap, decisions)
            kept_prefix = np.concatenate(
                [[0.0], np.cumsum(costs[decisions])[:-1]])
        spend = np.cumsum(costs[decisions])
    downgraded = int((decisions != orig).sum())
    return decisions, downgraded, float(spend[-1])


def downgrade_guard(decisions, costs, budget, cheap: int, valid=None, *,
                    passes: int = GUARD_PASSES):
    """decisions (b,) int chain index, costs (J,) f32 in the budget's
    units, valid (b,) 1.0 on real requests (None = all real).  Returns
    (decisions int32, downgraded int32, spend f32) as device tensors."""
    decisions = decisions.to(torch.int32)
    costs = costs.to(torch.float32)
    if valid is None:
        valid = torch.ones(decisions.shape, dtype=torch.float32,
                           device=decisions.device)
    else:
        valid = valid.to(torch.float32)
    c_min = costs[cheap]
    n_prefix = torch.cumsum(valid, dim=0)  # inclusive
    n_total = n_prefix[-1] if decisions.shape[0] else valid.sum()
    reserve = c_min * (n_total - n_prefix)  # valid requests after i
    orig = decisions
    real = valid > 0
    for _ in range(passes):
        c_dec = costs[decisions.long()]
        cd = c_dec * valid
        kept_prefix = torch.cumsum(cd, dim=0) - cd  # spend before i
        over = real & (kept_prefix + c_dec + reserve > budget)
        decisions = torch.where(over, torch.full_like(decisions, cheap),
                                decisions)
    spend = torch.sum(costs[decisions.long()] * valid)
    downgraded = torch.sum(((decisions != orig) & real).to(torch.int32))
    return decisions, downgraded, spend
