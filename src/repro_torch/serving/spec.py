"""Declarative constraint spec, global axis only.

The paper's system prices ONE budget per window with one scalar dual
price: ``ConstraintSpec([GlobalAxis(budget=B)])``.  Tenant and region
axes (per-tenant budgets, geo-shifting across serving regions) and
carbon pricing are not ported yet and are refused by ``compile``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GlobalAxis:
    """The single per-window budget of Eq. 3, in FLOPs."""

    budget: float

    def __post_init__(self):
        if not self.budget > 0:
            raise ValueError(f"budget must be positive, got {self.budget}")


@dataclass(frozen=True)
class CompiledSpec:
    """What ``ServingPipeline`` executes: the plain single-price mode."""

    global_: GlobalAxis
    mode: str = "plain"

    @property
    def total_budget(self) -> float:
        return float(self.global_.budget)


@dataclass(frozen=True)
class ConstraintSpec:
    """An ordered set of constraint axes (only ``GlobalAxis`` here)."""

    axes: tuple

    def __init__(self, axes):
        object.__setattr__(self, "axes", tuple(axes))

    def compile(self) -> CompiledSpec:
        if len(self.axes) != 1 or not isinstance(self.axes[0], GlobalAxis):
            raise NotImplementedError(
                "only [GlobalAxis(budget=...)] is supported; tenant and "
                "region axes are not ported yet")
        return CompiledSpec(global_=self.axes[0])
