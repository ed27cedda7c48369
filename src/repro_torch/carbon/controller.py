"""Carbon-denominated budgets for the primal-dual allocation loop.

The paper's constraint (Eq. 3) is a FLOPs budget per window.  Here the
budget becomes **gCO2e per window** with time-varying effective chain
costs

    c_j(t) = flops_j * kappa * CI(t)        [gCO2e]

where ``kappa`` is the Eq. 1 kWh-per-FLOP slope and CI(t) the grid
intensity seen by window t.  The existing machinery
(``allocate`` / ``dual_descent`` / ``downgrade_guard``) already takes an
arbitrary cost vector, so pricing computation in carbon is a change of
units, not of algorithm: the dual price lambda becomes reward-per-gram
and *persists across windows*, which is exactly what shifts computation
into green-grid hours - when CI drops, every chain gets cheaper in
carbon, the Eq. 10 argmax climbs the chain ladder, and the per-window
gram cap is still hard-enforced by the tail-reserve guard.

Two equivalent formulations are provided (both per-window LPs are the
same program up to a positive scalar):

  * ``pricing="carbon"`` - native: carbon cost vector + gram budget +
    carbon-space lambda.  The principled form: lambda does not need to
    re-converge when CI moves between windows.
  * ``pricing="flops"``  - reduction: FLOPs cost vector with the
    per-window *effective FLOPs budget* B_f(t) = B_g / (kappa * CI(t)),
    computed in ratio form ``flops_ref * (ci_ref / CI(t))`` so that a
    constant-CI trace yields B_f(t) == flops_ref BIT-EXACTLY (x/x == 1.0
    in IEEE) and the whole loop reproduces today's FLOPs-budget
    decisions bit-identically - the parity gate in
    tests/test_torch_carbon.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.carbon.intensity import IntensityTrace
from repro_torch.core.action_chain import ActionChainSet
from repro_torch.core.pfec import EnergyConfig, kwh_per_flop
from repro_torch.core.primal_dual import DualDescentConfig, window_step


def grams_per_flop(ci_g_per_kwh: float,
                   cfg: EnergyConfig | None = None) -> float:
    """kappa * CI: operational gCO2e emitted per FLOP served."""
    return kwh_per_flop(cfg) * float(ci_g_per_kwh)


def carbon_costs(flops_costs: np.ndarray, ci_g_per_kwh: float,
                 cfg: EnergyConfig | None = None) -> np.ndarray:
    """The time-varying effective cost vector c_j(t) [gCO2e]."""
    return np.asarray(flops_costs, np.float64) \
        * grams_per_flop(ci_g_per_kwh, cfg)


@dataclass(frozen=True)
class CarbonBudget:
    """A per-window gCO2e budget against a grid-intensity trace.

    Canonical fields are ``flops_ref`` (the FLOPs the budget admits at
    the reference intensity ``ci_ref``) rather than raw grams: the
    effective FLOPs budget is then the exact ratio
    ``flops_ref * (ci_ref / CI(t))``, algebraically equal to
    ``grams_per_window / (kappa * CI(t))`` but bit-stable when
    CI(t) == ci_ref (the constant-CI parity case).
    """

    flops_ref: float
    ci_ref: float
    trace: IntensityTrace
    cfg: EnergyConfig = field(default_factory=EnergyConfig)
    window_s: float = 3600.0
    phase_s: float = 0.0

    @classmethod
    def from_flops(cls, flops_budget: float, trace: IntensityTrace, *,
                   ci_ref: float | None = None,
                   cfg: EnergyConfig | None = None,
                   window_s: float = 3600.0,
                   phase_s: float = 0.0) -> "CarbonBudget":
        """The gram budget that admits ``flops_budget`` FLOPs per window
        at ``ci_ref`` (default: the trace mean) - how a FLOPs-budgeted
        deployment is migrated to a carbon-budgeted one."""
        return cls(flops_ref=float(flops_budget),
                   ci_ref=float(trace.mean() if ci_ref is None else ci_ref),
                   trace=trace, cfg=cfg or EnergyConfig(),
                   window_s=window_s, phase_s=phase_s)

    @classmethod
    def from_grams(cls, grams_per_window: float, trace: IntensityTrace, *,
                   ci_ref: float | None = None,
                   cfg: EnergyConfig | None = None,
                   window_s: float = 3600.0,
                   phase_s: float = 0.0) -> "CarbonBudget":
        cfg = cfg or EnergyConfig()
        ci_ref = float(trace.mean() if ci_ref is None else ci_ref)
        return cls(flops_ref=float(grams_per_window)
                   / grams_per_flop(ci_ref, cfg),
                   ci_ref=ci_ref, trace=trace, cfg=cfg,
                   window_s=window_s, phase_s=phase_s)

    @property
    def grams_per_window(self) -> float:
        return self.flops_ref * grams_per_flop(self.ci_ref, self.cfg)

    def ci(self, t: int) -> float:
        """Grid intensity seen by window t (trace mean over its span)."""
        return self.trace.window_mean(self.phase_s + t * self.window_s,
                                      self.window_s)

    def scale(self, t: int) -> float:
        """kappa * CI(t): the FLOPs->gCO2e cost scale for window t."""
        return grams_per_flop(self.ci(t), self.cfg)

    def flops_budget(self, t: int) -> float:
        """Effective FLOPs budget B_g / (kappa*CI(t)), in ratio form."""
        return self.flops_ref * (self.ci_ref / self.ci(t))

    def schedule(self, n_windows: int) -> dict[str, np.ndarray]:
        """Vectorized per-window (ci, cost scale, flops budget) arrays -
        what a streaming driver feeds ``run_stream``."""
        ci = np.array([self.ci(t) for t in range(n_windows)], np.float64)
        kpf = kwh_per_flop(self.cfg)
        return {"ci": ci, "scale": ci * kpf,
                "flops_budget": self.flops_ref * (self.ci_ref / ci),
                "grams": np.full(n_windows, self.grams_per_window)}


@dataclass
class CarbonWindowStats:
    """Per-window record of the carbon-budgeted controller."""

    n_requests: int
    ci_g_per_kwh: float
    flops: float
    spend_g: float
    budget_g: float
    lam: float  # reward per gCO2e (carbon pricing) or per FLOP (flops)
    downgraded: int


@dataclass
class CarbonBudgetController:
    """Carbon-denominated sibling of ``core.budget.BudgetController``.

    Each window t: decide with the persisted dual price, hard-cap spend
    with the tail-reserve guard, meter into the optional ledger, then
    run the nearline dual update - all against the window's effective
    costs.  ``pricing`` selects the formulation (see module docstring);
    both enforce spend_g <= grams_per_window whenever the floor fits.
    """

    chains: ActionChainSet
    budget: CarbonBudget
    dual_cfg: DualDescentConfig = field(default_factory=DualDescentConfig)
    guard: bool = True
    pricing: str = "carbon"
    ledger: object = None  # CarbonLedger, duck-typed to avoid the import

    def __post_init__(self):
        if self.pricing not in ("carbon", "flops"):
            raise ValueError(f"pricing must be 'carbon' or 'flops', "
                             f"got {self.pricing!r}")
        # the published price: an f32 scalar, as window_step returns it
        self.lam = torch.tensor(self.dual_cfg.lam_init, dtype=torch.float32)
        self.stats: list[CarbonWindowStats] = []

    @classmethod
    def from_spec(cls, chains: ActionChainSet, spec,
                  trace: IntensityTrace, *, window_s: float = 3600.0,
                  phase_s: float = 0.0, ci_ref: float | None = None,
                  **kw) -> "CarbonBudgetController":
        """Build the carbon host loop from a ConstraintSpec.

        The spec's ``GlobalAxis`` supplies the per-window reference
        budget (in FLOPs at ``ci_ref``, default the trace mean) and the
        pricing formulation; tenant/region axes need the fused
        ``ServingPipeline.from_spec``.
        """
        cs = spec.compile()
        if cs.mode != "plain":
            raise ValueError(
                f"the host-loop CarbonBudgetController serves the plain "
                f"single-budget spec only (got mode {cs.mode!r}); use "
                f"ServingPipeline.from_spec for tenant/region axes")
        cb = CarbonBudget.from_flops(cs.total_budget, trace,
                                     ci_ref=ci_ref, window_s=window_s,
                                     phase_s=phase_s)
        return cls(chains, cb, pricing=cs.pricing, **kw)

    def step_window(self, rewards: np.ndarray) -> np.ndarray:
        """Serve one window: Eq. 10 decide -> guard -> ledger -> dual.

        The loop body is ``core.primal_dual.window_step`` - the SAME
        implementation the FLOPs-budget ``BudgetController`` wraps;
        pricing carbon is only a change of cost vector and cap.
        ``rewards`` is an (I, J) tensor (its device runs the arithmetic)
        or an array."""
        t = len(self.stats)
        ci = self.budget.ci(t)
        scale = self.budget.scale(t)
        if self.pricing == "carbon":
            costs = self.chains.costs * scale  # gCO2e
            cap = self.budget.grams_per_window
        else:  # flops reduction: same LP, costs stay in FLOPs
            costs = self.chains.costs
            cap = self.budget.flops_budget(t)
        decisions, downgraded, spend, self.lam = window_step(
            rewards, costs, cap, self.lam, cheap=self.chains.cheapest(),
            guard=self.guard, cfg=self.dual_cfg)
        flops = float(np.sum(self.chains.costs[decisions]))
        if self.ledger is not None:
            self.ledger.record(decisions, t=t, ci=ci)
        spend_g = spend if self.pricing == "carbon" else spend * scale
        self.stats.append(CarbonWindowStats(
            n_requests=len(decisions), ci_g_per_kwh=ci, flops=flops,
            spend_g=spend_g, budget_g=self.budget.grams_per_window,
            lam=float(self.lam), downgraded=downgraded))
        return decisions

    def spend_trace_g(self) -> np.ndarray:
        return np.array([s.spend_g for s in self.stats])
