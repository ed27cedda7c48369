"""Comparison methods (paper §5.1): EQUAL and CRAS.

* EQUAL - every request gets the same fixed action chain; the chain is the
  most expensive one that fits the per-request budget share C/I.  Variants
  EQUAL-DIN / EQUAL-DIEN restrict the ranking-stage model pool.

* CRAS (Yang et al. 2021) - decomposes allocation into INDEPENDENT
  per-stage subproblems: stage k has its own reward model r_k(f_i, a_k)
  (no cross-stage state) and its own budget share C_k, solved with the same
  primal-dual machinery.  The combined decision is the per-stage argmaxes
  stitched into a chain.  This reproduces the paper's observation that
  ignoring cross-stage effects costs revenue (Table 2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.action_chain import ActionChainSet
from repro_torch.core.primal_dual import allocate, dual_bisect


def equal_allocation(chains: ActionChainSet, budget: float, n_requests: int,
                     *, rank_model: str | None = None) -> int:
    """Fixed chain index for everyone: costliest chain with I*c_j <= C."""
    per_request = budget / max(1, n_requests)
    mask = np.ones(chains.n_chains, bool)
    if rank_model is not None:
        k_rank = chains.n_stages - 1
        model_names = [m.name for m in chains.stages[k_rank].models]
        want = model_names.index(rank_model)
        mask = chains.chain_idx[:, k_rank, 0] == want
    costs = np.where(mask, chains.costs, np.inf)
    affordable = costs <= per_request
    if not affordable.any():
        # nothing fits: fall back to the cheapest allowed chain (downgrade)
        return int(np.argmin(costs))
    return int(np.argmax(np.where(affordable, chains.costs, -np.inf)))


@dataclass
class StageActionSpace:
    """Flattened (model, scale) actions of one stage with per-action cost."""

    stage_k: int
    actions: np.ndarray  # (A_k, 2) int32 (model_idx, scale_idx)
    costs: np.ndarray  # (A_k,) float

    @classmethod
    def from_chains(cls, chains: ActionChainSet, k: int) -> "StageActionSpace":
        st = chains.stages[k]
        acts, costs = [], []
        for mi, m in enumerate(st.models):
            for si, n in enumerate(st.item_scales):
                acts.append((mi, si))
                costs.append(m.fixed_flops + m.flops_per_item * n)
        return cls(k, np.asarray(acts, np.int32), np.asarray(costs))


def cras_allocation(stage_rewards: list, stage_spaces: list[StageActionSpace],
                    chains: ActionChainSet, budget: float,
                    *, rank_model: str | None = None) -> np.ndarray:
    """Per-stage independent primal-dual (Yang et al. 2021 style).

    stage_rewards[k]: (I, A_k) independently-estimated stage revenues
    (tensors or arrays).  The budget is split across stages in
    proportion to each stage's maximum spend, then each stage solves its
    own scalar dual price.  Returns (I,) chain indices into ``chains``.
    """
    n_req = stage_rewards[0].shape[0]
    max_spend = np.array([sp.costs.max() for sp in stage_spaces])
    shares = max_spend / max_spend.sum()

    per_stage_choice = []
    for k, (rw, sp) in enumerate(zip(stage_rewards, stage_spaces)):
        costs = sp.costs.copy()
        if rank_model is not None and k == chains.n_stages - 1:
            names = [m.name for m in chains.stages[k].models]
            want = names.index(rank_model)
            banned = sp.actions[:, 0] != want
            costs = np.where(banned, 1e30, costs)  # price them out
        rw = torch.as_tensor(rw)
        c = torch.as_tensor(costs, dtype=torch.float32, device=rw.device)
        lam = dual_bisect(rw, c, budget * shares[k])
        per_stage_choice.append(allocate(rw, c, lam).cpu().numpy())

    # stitch per-stage actions into chain indices
    lookup = {}
    for j in range(chains.n_chains):
        lookup[tuple(map(tuple, chains.chain_idx[j]))] = j

    out = np.zeros((n_req,), np.int32)
    for i in range(n_req):
        choice = []
        for k, sp in enumerate(stage_spaces):
            a = sp.actions[per_stage_choice[k][i]]
            choice.append((int(a[0]), int(a[1])))
        key = tuple(choice)
        if key not in lookup:
            # per-stage independence can pick n_{k+1} > n_k, which the
            # cascade prunes: clamp the downstream scale to the feasible
            # maximum
            key = tuple(_clamp_feasible(chains, choice))
        out[i] = lookup[key]
    return out


def _clamp_feasible(chains: ActionChainSet, choice):
    fixed = [list(choice[0])]
    for k in range(1, len(choice)):
        mi, si = choice[k]
        up_scale = chains.stages[k - 1].item_scales[fixed[k - 1][1]]
        scales = chains.stages[k].item_scales
        while si > 0 and scales[si] > up_scale:
            si -= 1
        fixed.append([mi, si])
    return [tuple(c) for c in fixed]
