"""Declarative ConstraintSpec API: tenants x regions x carbon, one pipeline.

An operator declares the constraint axes and the spec compiles them onto
the allocator core's structures:

    ConstraintSpec([
        TenantAxis(budgets=(g0, g1, g2), priced=True),
        RegionAxis(n_regions=2),
        GlobalAxis(pricing="carbon"),
    ])

compiles to the ``(M, K)`` option->constraint cost map, the ``(I, K)``
per-request membership, the ``(K,)`` budget/price vectors and the per-K
guard ``k_of`` that ``ServingPipeline.from_spec`` runs in one window
pass.  K is the concatenation of the declared axes' price components:

    axes declared            priced K          guard constraints
    -----------------------  ----------------  ------------------------
    GlobalAxis               scalar (paper)    1 global budget
    TenantAxis(shared)       scalar            T tenant budgets
    TenantAxis(priced)       T                 T tenant budgets
    RegionAxis               R                 R region budgets
    TenantAxis(priced)+      T + R             T tenant + R region
      RegionAxis                                 budgets (two chained
                                                 tail-reserve walks)

With both axes the option space is M = J * R (chain x serving region,
region-major: option m = r*J + j) and a request of tenant t pays
``(lam_tenant[t] + lam_region[r]) * c_{j,r}(t)`` for option (j, r).
``c_{j,r}(t) = flops_j * scale_r(t)`` rides through the per-window
``cost_scale`` (carbon: scale_r = kappa * CI_r(t)), so carbon is a
choice of units, never a separate wiring.

``spec_from_legacy`` maps the older keyword form (``budget_per_window``,
``tenant_budgets``/``tenant_mode``, ``n_regions``) onto a spec.

Region ties (``RegionAxis.split``): the cost structure is proportional
(c_{j,r} = s_r * flops_j), so at the dual equilibrium every request is
indifferent between regions at once and a pure argmax moves whole
windows.  ``split="flow"`` (the default) divides the requests whose
per-flop priced costs tie across regions deterministically in arrival
order, each tied region receiving a share of the window's FLOPs mass
proportional to its remaining budget capacity - the flow-splitting
primal rounding of the fractional LP optimum.  ``split="argmax"`` keeps
the pure argmax (the legacy ``n_regions`` form maps there).

The constructors at the bottom (``tenant_member``, ``region_cost_map``,
``dual_cost_map``, ``dual_member``) run inside the window programs on
device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

VALID_SPLITS = ("flow", "argmax")
VALID_PRICINGS = ("flops", "carbon")


@dataclass(frozen=True)
class TenantAxis:
    """T per-tenant budgets; windows carry T equal-size tenant blocks.

    ``priced=False`` ("shared"): one dual price descends on the total
    budget while the guard hard-caps each tenant's block.
    ``priced=True``: a (T,) per-tenant price vector, each price
    descending on its own consumption-vs-budget subgradient.
    """

    budgets: tuple[float, ...]
    priced: bool = False

    def __post_init__(self):
        budgets = tuple(float(b) for b in self.budgets)
        object.__setattr__(self, "budgets", budgets)
        if len(budgets) < 1:
            raise ValueError("TenantAxis needs at least one budget")
        if any(b <= 0 for b in budgets):
            raise ValueError(f"tenant budgets must be positive, "
                             f"got {budgets}")

    @property
    def n(self) -> int:
        return len(self.budgets)


@dataclass(frozen=True)
class RegionAxis:
    """R serving regions: each request picks (chain, region) through the
    priced argmax at region costs c_{j,r}(t) = flops_j * scale_r(t).

    Per-region budgets and cost scales ride the per-window
    ``serve_window(budget=..., cost_scale=...)`` vectors.  ``split``
    selects the tie rounding (module docstring); ``tie_tol`` is the
    relative per-flop price band treated as tied.
    """

    n_regions: int = 2
    names: tuple[str, ...] | None = None
    split: str = "flow"
    tie_tol: float = 0.05

    def __post_init__(self):
        if self.n_regions < 2:
            raise ValueError("RegionAxis needs >= 2 serving regions")
        if self.split not in VALID_SPLITS:
            raise ValueError(f"split must be one of {VALID_SPLITS}, "
                             f"got {self.split!r}")
        if not 0.0 <= self.tie_tol < 1.0:
            raise ValueError(f"tie_tol must be in [0, 1), "
                             f"got {self.tie_tol}")
        if self.names is not None and len(self.names) != self.n_regions:
            raise ValueError(f"{len(self.names)} names for "
                             f"{self.n_regions} regions")

    @property
    def n(self) -> int:
        return int(self.n_regions)


@dataclass(frozen=True)
class GlobalAxis:
    """The paper's single budget (Eq. 3) and the pricing denomination.

    ``budget`` is the per-window reference budget (required when no
    TenantAxis carries budgets; with tenants it defaults to their sum).
    ``pricing`` names the cost units a serving loop threads through the
    per-window traces: "flops" (scale 1.0) or "carbon" (scale
    kappa*CI(t), budgets in gCO2e).  The pipeline itself is unit-agnostic.
    """

    budget: float | None = None
    pricing: str = "flops"

    def __post_init__(self):
        if self.pricing not in VALID_PRICINGS:
            raise ValueError(f"pricing must be one of {VALID_PRICINGS}, "
                             f"got {self.pricing!r}")
        if self.budget is not None and self.budget <= 0:
            raise ValueError(f"budget must be positive, "
                             f"got {self.budget}")


@dataclass(frozen=True)
class ConstraintSpec:
    """An ordered set of constraint axes; ``compile()`` resolves them
    into the description the pipeline executes."""

    axes: tuple

    def __init__(self, axes):
        object.__setattr__(self, "axes", tuple(axes))

    def compile(self) -> "CompiledSpec":
        tenants = regions = global_ = None
        for ax in self.axes:
            if isinstance(ax, TenantAxis):
                if tenants is not None:
                    raise ValueError("duplicate TenantAxis")
                tenants = ax
            elif isinstance(ax, RegionAxis):
                if regions is not None:
                    raise ValueError("duplicate RegionAxis")
                regions = ax
            elif isinstance(ax, GlobalAxis):
                if global_ is not None:
                    raise ValueError("duplicate GlobalAxis")
                global_ = ax
            else:
                raise TypeError(f"unknown constraint axis {ax!r} (want "
                                f"TenantAxis | RegionAxis | GlobalAxis)")
        if tenants is None and (global_ is None or global_.budget is None):
            raise ValueError("a ConstraintSpec needs a budget source: "
                             "GlobalAxis(budget=...) or TenantAxis")
        return CompiledSpec(spec=self, tenants=tenants, regions=regions,
                            global_=global_ or GlobalAxis())


@dataclass(frozen=True)
class CompiledSpec:
    """The resolved constraint structure ``ServingPipeline`` executes.

    ``k_names`` orders the priced constraints as the (K,) price vector,
    the (K,) budget vector and the dual cost-map columns: tenant columns
    first (priced tenants), region columns after.  ``n_prices == 0``
    means the scalar (paper) price.
    """

    spec: ConstraintSpec
    tenants: TenantAxis | None
    regions: RegionAxis | None
    global_: GlobalAxis = field(default_factory=GlobalAxis)

    @property
    def t_n(self) -> int | None:
        return None if self.tenants is None else self.tenants.n

    @property
    def r_n(self) -> int | None:
        return None if self.regions is None else self.regions.n

    @property
    def tenant_priced(self) -> bool:
        return self.tenants is not None and self.tenants.priced

    @property
    def mode(self) -> str:
        """Which window program runs: plain|tenants|geo|geotenants."""
        if self.tenants is not None and self.regions is not None:
            return "geotenants"
        if self.regions is not None:
            return "geo"
        if self.tenants is not None:
            return "tenants"
        return "plain"

    @property
    def n_prices(self) -> int:
        """Length of the (K,) price vector; 0 = scalar price."""
        k = 0
        if self.tenant_priced:
            k += self.tenants.n
        if self.regions is not None:
            k += self.regions.n
        return k

    def _region_names(self) -> list[str]:
        return list(self.regions.names or tuple(
            f"region[{r}]" for r in range(self.regions.n)))

    def _tenant_names(self) -> list[str]:
        return [f"tenant[{t}]" for t in range(self.tenants.n)]

    @property
    def k_names(self) -> tuple[str, ...]:
        names = []
        if self.tenant_priced:
            names += self._tenant_names()
        if self.regions is not None:
            names += self._region_names()
        return tuple(names)

    @property
    def total_budget(self) -> float:
        if self.global_.budget is not None:
            return float(self.global_.budget)
        return float(sum(self.tenants.budgets))

    @property
    def pricing(self) -> str:
        return self.global_.pricing

    @property
    def split(self) -> str:
        return "argmax" if self.regions is None else self.regions.split

    @property
    def tie_tol(self) -> float:
        return 0.0 if self.regions is None else float(self.regions.tie_tol)

    def budget_len(self) -> int:
        """Entries of a per-window ``budget`` vector: tenant budgets
        first, region budgets after (1 for the plain scalar mode)."""
        return len(self.budget_names)

    @property
    def budget_names(self) -> tuple[str, ...]:
        """Axis names of the per-window ``budget`` vector in positional
        order (the named ``serve_window`` form keys a dict by these):
        every tenant has an entry even when tenants share one price;
        ``("global",)`` in the plain mode."""
        names = []
        if self.tenants is not None:
            names += self._tenant_names()
        if self.regions is not None:
            names += self._region_names()
        return tuple(names) or ("global",)

    @property
    def scale_names(self) -> tuple[str, ...]:
        """Axis names of the per-window ``cost_scale`` vector: one per
        region, else one global scalar."""
        if self.regions is not None:
            return tuple(self._region_names())
        return ("global",)

    # -- core-structure constructors (device tensors, in the programs) ----

    def tenant_member(self, k_of):
        """(I,) tenant index -> (I, T) one-hot membership."""
        t = torch.arange(self.tenants.n, device=k_of.device)
        return (k_of[:, None] == t[None, :]).to(torch.float32)

    def region_cost_map(self, opt_costs, j_n: int):
        """(M,) region-major option costs -> (M, R) cost map: option
        m = r*J + j draws c_{j,r} from region column r only."""
        r_n = self.regions.n
        eye = torch.eye(r_n, dtype=torch.float32, device=opt_costs.device)
        rep = eye[:, None, :].expand(r_n, j_n, r_n).reshape(r_n * j_n, r_n)
        return opt_costs[:, None] * rep

    def dual_cost_map(self, opt_costs, j_n: int):
        """The (M, K) dual cost map in ``k_names`` order: priced tenant
        columns draw a request's cost wherever it is served, region
        columns only from their own region's options."""
        cols = []
        if self.tenant_priced:
            cols.append(opt_costs[:, None].expand(opt_costs.shape[0],
                                                  self.tenants.n))
        if self.regions is not None:
            cols.append(self.region_cost_map(opt_costs, j_n))
        if not cols:
            return opt_costs[:, None]
        return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)

    def dual_member(self, k_of, n_rows: int):
        """The (I, K) dual membership in ``k_names`` order: tenant
        one-hots, all-ones region columns (every request may be served
        in any region; the cost map zeroes the off-region draw).
        ``None`` when the membership is trivial."""
        if self.mode != "geotenants" or not self.tenant_priced:
            return None
        ones = torch.ones((n_rows, self.regions.n), dtype=torch.float32,
                          device=k_of.device)
        return torch.cat([self.tenant_member(k_of), ones], dim=1)


def spec_from_legacy(budget_per_window: float, *, tenant_budgets=None,
                     tenant_mode: str = "shared",
                     n_regions: int | None = None) -> ConstraintSpec:
    """The keyword form -> its ConstraintSpec: ``tenant_budgets`` with
    ``tenant_mode`` "shared" or "priced" becomes a TenantAxis,
    ``n_regions`` a ``RegionAxis(split="argmax")``, and the budget a
    GlobalAxis."""
    if tenant_mode not in ("shared", "priced"):
        raise ValueError(f"tenant_mode must be 'shared' or 'priced', "
                         f"got {tenant_mode!r}")
    axes = []
    if tenant_budgets is not None:
        axes.append(TenantAxis(tuple(float(b) for b in tenant_budgets),
                               priced=tenant_mode == "priced"))
    if n_regions is not None:
        axes.append(RegionAxis(int(n_regions), split="argmax"))
    axes.append(GlobalAxis(budget=float(budget_per_window)))
    return ConstraintSpec(axes)
