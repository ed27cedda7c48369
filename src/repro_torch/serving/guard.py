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
    for padded windows: one budget, or K per-constraint budgets;
  * ``downgrade_guard_chain`` - several constraint families in turn;
  * ``downgrade_guard_np``  - the NumPy float64 host form.

Per-constraint budgets: ``k_of`` maps each request to its constraint
(tenant, serving region), ``budget`` is (K,) and ``cheap`` the
per-constraint downgrade option ((K,), e.g. the cheapest chain within a
request's region) or one shared option.  Each constraint walks its own
requests: one (b,) cumsum per constraint column, zeros off a request's
own constraint, so every prefix is bit-equal to a walk over that
constraint's requests alone and K = 1 is the single-budget walk.

``downgrade_guard_chain`` composes families over one window (tenant
budgets, then region budgets): each walk guards the previous walk's
output.  That is safe because a walk only moves requests to a cheapest
option, so a later walk only lowers the spends an earlier one capped.

``downgraded`` counts requests whose final decision differs from the
allocator's.

Over a request mesh (``n_shards`` S > 1) every walk runs over the whole
window with the JAX package's sharded sums: each prefix is a per-shard
cumsum plus the shard's exclusive offset (the ordered sum of the earlier
shards' totals), and ``n_total``, the spends and ``downgraded`` are
shard-ordered sums (``distributed.sharding``).  One shard runs the
unsharded walk itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_prefix, shard_sum

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


def _valid(decisions, valid):
    if valid is None:
        return torch.ones(decisions.shape, dtype=torch.float32,
                          device=decisions.device)
    return valid.to(torch.float32)


def downgrade_guard(decisions, costs, budget, cheap, valid=None, *,
                    k_of=None, passes: int = GUARD_PASSES,
                    n_shards: int = 1):
    """decisions (b,) int option index, costs (M,) f32 in the budget's
    units, valid (b,) 1.0 on real requests (None = all real).

    One budget (``k_of`` None): ``budget`` a number or 0-dim tensor,
    ``cheap`` an option index.  K budgets: ``k_of`` (b,) int maps each
    request to its constraint, ``budget`` is (K,) and ``cheap`` a (K,)
    tensor or one index; ``spend`` comes back (K,).  ``n_shards`` splits
    the window into that many request shards (see the module docstring).
    Returns (decisions int32, downgraded int32, spend f32) as device
    tensors."""
    decisions = decisions.to(torch.int32)
    costs = costs.to(torch.float32)
    valid = _valid(decisions, valid)
    if k_of is not None:
        return _downgrade_guard_k(decisions, costs, budget, cheap, valid,
                                  k_of, passes, n_shards)
    c_min = costs[cheap]
    n_prefix, n_total = shard_prefix(valid, n_shards)  # inclusive
    reserve = c_min * (n_total - n_prefix)  # valid requests after i
    orig = decisions
    real = valid > 0
    for _ in range(passes):
        c_dec = costs[decisions.long()]
        cd = c_dec * valid
        kept_prefix = shard_prefix(cd, n_shards)[0] - cd  # spend before i
        over = real & (kept_prefix + c_dec + reserve > budget)
        decisions = torch.where(over, torch.full_like(decisions, cheap),
                                decisions)
    spend = shard_sum(costs[decisions.long()] * valid, n_shards)
    downgraded = shard_sum(((decisions != orig) & real).to(torch.int32),
                           n_shards)
    return decisions, downgraded, spend


def _per_k_sum(x, onehot, n_shards: int = 1):
    """(b,) values -> (K,) per-constraint sums, one (b,) sum a column."""
    return torch.stack([shard_sum(x * onehot[:, k], n_shards)
                        for k in range(onehot.shape[1])])


def _downgrade_guard_k(decisions, costs, budget, cheap, valid, k_of,
                       passes, n_shards: int = 1):
    """The per-constraint walk of ``downgrade_guard``: constraint k
    guards its own requests against budget[k], all K walks at once."""
    dev = decisions.device
    budget = torch.as_tensor(budget, dtype=torch.float32, device=dev)
    k_n = int(budget.shape[0])
    k_of = k_of.long()
    if isinstance(cheap, torch.Tensor):
        cheap_k = cheap.to(device=dev, dtype=torch.int64).expand(k_n)
    else:  # a fill, not a host copy: the walk stays capturable
        cheap_k = torch.full((k_n,), int(cheap), dtype=torch.int64,
                             device=dev)
    cheap_i = cheap_k[k_of].to(torch.int32)  # (b,) downgrade option
    c_min_i = costs[cheap_k][k_of]  # (b,) reserve unit per request
    budget_i = budget[k_of]
    onehot = (k_of[:, None] == torch.arange(k_n, device=dev)[None, :]
              ).to(torch.float32)

    def per_k_prefix(x):
        """(b,) -> inclusive per-k prefix (b, K), one cumsum a column,
        and its (K,) totals."""
        cols = [shard_prefix(x * onehot[:, k], n_shards)
                for k in range(k_n)]
        return (torch.stack([c[0] for c in cols], dim=1),
                torch.stack([c[1] for c in cols]))

    # tail reserve: valid requests of k strictly after i (one nonzero
    # term a row, so the row sums below are exact in any order)
    n_prefix, n_total = per_k_prefix(valid)
    tail = torch.sum((n_total[None, :] - n_prefix) * onehot, dim=1)
    reserve = c_min_i * tail
    orig = decisions
    real = valid > 0
    for _ in range(passes):
        c_dec = costs[decisions.long()]
        cd = c_dec * valid
        kept_prefix = torch.sum(per_k_prefix(cd)[0] * onehot, dim=1) - cd
        over = real & (kept_prefix + c_dec + reserve > budget_i)
        decisions = torch.where(over, cheap_i, decisions)
    spend = _per_k_sum(costs[decisions.long()] * valid, onehot, n_shards)
    downgraded = shard_sum(((decisions != orig) & real).to(torch.int32),
                           n_shards)
    return decisions, downgraded, spend


def downgrade_guard_chain(decisions, costs, plans, valid=None, *,
                          passes: int = GUARD_PASSES, n_shards: int = 1):
    """Per-constraint-family walks over one window, in order.

    ``plans`` is a sequence of ``(budget, cheap, k_of)`` triples, one a
    family (e.g. tenant budgets, then region budgets); each family sees
    the previous family's decisions.  A callable ``k_of`` is called with
    the current decisions (region membership follows the option, so it
    must follow earlier downgrades).  Returns ``(decisions, downgraded,
    spends)``: ``spends`` lists each family's (K,) spend of the final
    decisions, ``downgraded`` counts changed valid requests once."""
    decisions = decisions.to(torch.int32)
    costs = costs.to(torch.float32)
    valid = _valid(decisions, valid)
    orig = decisions
    for budget, cheap, k_of in plans:
        k_now = k_of(decisions) if callable(k_of) else k_of
        decisions, _, _ = downgrade_guard(decisions, costs, budget, cheap,
                                          valid, k_of=k_now, passes=passes,
                                          n_shards=n_shards)
    cd = costs[decisions.long()] * valid
    spends = []
    for budget, _, k_of in plans:
        k_of = (k_of(decisions) if callable(k_of) else k_of).long()
        k_n = int(budget.shape[0])
        onehot = (k_of[:, None] == torch.arange(
            k_n, device=k_of.device)[None, :]).to(torch.float32)
        spends.append(_per_k_sum(cd, onehot, n_shards))
    changed = shard_sum(((decisions != orig) & (valid > 0))
                        .to(torch.int32), n_shards)
    return decisions, changed, spends
