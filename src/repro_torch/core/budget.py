"""Budget controller: keeps realized consumption under the global budget
even through traffic spikes (paper Fig. 5).

Two mechanisms compose:

  * the nearline dual price reacts within one window (more requests at the
    same price -> overshoot -> price rises next window);
  * a hard downgrade guard inside the window: if the running spend would
    exceed the window budget, remaining requests are forced onto the
    cheapest chain ("computation downgrade" in the paper's words).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.action_chain import ActionChainSet
from repro_torch.core.primal_dual import (DualDescentConfig, DynamicPrimalDual,
                                          window_step)


@dataclass
class WindowStats:
    n_requests: int
    spend: float
    budget: float
    lam: float
    downgraded: int


@dataclass
class BudgetController:
    chains: ActionChainSet
    budget_per_window: float
    dual_cfg: DualDescentConfig = field(default_factory=DualDescentConfig)
    guard: bool = True

    def __post_init__(self):
        self.pd = DynamicPrimalDual(self.chains.costs, self.budget_per_window,
                                    self.dual_cfg)
        self.stats: list[WindowStats] = []

    @classmethod
    def from_spec(cls, chains: ActionChainSet, spec, **kw
                  ) -> "BudgetController":
        """The host loop serves the paper's single-budget system: only a
        plain FLOPs ``[GlobalAxis(budget=...)]`` spec maps here; tenant
        and region axes need ``ServingPipeline.from_spec``."""
        cs = spec.compile()
        if cs.mode != "plain":
            raise ValueError(
                f"the host-loop BudgetController serves the plain "
                f"single-budget spec only (got mode {cs.mode!r}); "
                f"use ServingPipeline.from_spec for tenant/region axes")
        if cs.pricing != "flops":
            raise ValueError("the host-loop BudgetController prices FLOPs; "
                             "carbon pricing needs per-window cost scales")
        return cls(chains, cs.total_budget, **kw)

    def step_window(self, rewards) -> np.ndarray:
        """Serve one traffic window: decide with lambda_{t-1}, apply the
        downgrade guard, then update the price for t+1
        (``core.primal_dual.window_step``).

        rewards: (I_t, J) estimated rewards (a tensor on any device, or
        an array).  Returns the (possibly downgraded) chain per request.
        """
        decisions, downgraded, spend, lam_new = window_step(
            rewards, self.chains.costs, self.budget_per_window, self.pd.lam,
            cheap=self.chains.cheapest(), guard=self.guard,
            cfg=self.dual_cfg)
        self.pd.lam = lam_new
        self.pd.history.append(float(lam_new))
        self.stats.append(WindowStats(
            n_requests=len(decisions), spend=spend,
            budget=self.budget_per_window, lam=float(lam_new),
            downgraded=downgraded))
        return decisions

    def spend_trace(self) -> np.ndarray:
        return np.array([s.spend for s in self.stats])
