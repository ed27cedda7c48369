"""Action chains — the allocation unit of GreenFlow (paper §3.1, §4.1).

A cascade RS has K stages. Stage k picks a model instance ``m_k`` from its
*Model Pool* and an item scale ``n_k`` from its *Item Scale* set.  An action
chain ``a = ((m_1, n_1), ..., (m_K, n_K))`` fixes the computation of one
request end to end.  The generator enumerates the Cartesian product over
stages and pre-computes, for every chain j:

  * integer encodings   (J, K, 2)  -> (model_idx, scale_idx) per stage
  * FLOPs cost vector   (J,)       -> c_j = sum_k n_k * flops_per_item(m_k)
  * reward-model features: per-stage model one-hot + multi-hot scale code

Everything is plain NumPy arrays, so the chain set is device-agnostic: the
serving code uploads what it needs once.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class ModelInstance:
    """A trained instance available in a stage's model pool (paper Table 1)."""

    name: str
    flops_per_item: float  # FLOPs to score ONE candidate item
    fixed_flops: float = 0.0  # per-request overhead independent of n_k
    auc: float | None = None  # bookkeeping only


@dataclass(frozen=True)
class StageSpec:
    """One cascade stage: its model pool and item-scale set."""

    name: str
    models: tuple[ModelInstance, ...]
    item_scales: tuple[int, ...]  # paper's N_k, ascending
    n_scale_groups: int = 4  # Q: multi-hot groups for the scale embedding

    def __post_init__(self):
        if tuple(sorted(self.item_scales)) != tuple(self.item_scales):
            raise ValueError(f"item_scales for stage {self.name} must ascend")
        if not self.models:
            raise ValueError(f"stage {self.name} has an empty model pool")

    @property
    def n_models(self) -> int:
        return len(self.models)

    @property
    def n_scales(self) -> int:
        return len(self.item_scales)

    def scale_group(self, scale_idx: int) -> int:
        """Which of the Q groups a scale index falls in (paper §4.2)."""
        q = self.n_scale_groups
        # ceil-partition the ascending scale list into Q contiguous groups
        return min(q - 1, scale_idx * q // max(1, self.n_scales))

    def multi_hot(self, scale_idx: int) -> np.ndarray:
        """Monotone multi-hot code: larger scale -> more ones (paper §4.2)."""
        g = self.scale_group(scale_idx)
        v = np.zeros((self.n_scale_groups,), np.float32)
        v[: g + 1] = 1.0
        return v


@dataclass
class ActionChainSet:
    """The enumerated chain set A with |A| = J and all derived arrays."""

    stages: tuple[StageSpec, ...]
    chain_idx: np.ndarray  # (J, K, 2) int32: (model_idx, scale_idx)
    costs: np.ndarray  # (J,) float64 FLOPs per request
    model_onehot: np.ndarray  # (J, K, max_models) float32
    scale_multihot: np.ndarray  # (J, K, Q) float32
    scale_value: np.ndarray  # (J, K) float32 raw n_k (for logging/cost)
    names: list[str] = field(default_factory=list)

    @property
    def n_chains(self) -> int:
        return int(self.chain_idx.shape[0])

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def chain_name(self, j: int) -> str:
        return self.names[j]

    def cheapest(self) -> int:
        return int(np.argmin(self.costs))

    def most_expensive(self) -> int:
        return int(np.argmax(self.costs))

    def describe(self, j: int) -> str:
        parts = []
        for k, st in enumerate(self.stages):
            mi, si = self.chain_idx[j, k]
            parts.append(f"{st.name}:{st.models[mi].name}@{st.item_scales[si]}")
        return " -> ".join(parts)


def chain_cost(stages: Sequence[StageSpec], choice) -> float:
    """FLOPs of one chain. choice = [(model_idx, scale_idx), ...]."""
    total = 0.0
    for st, (mi, si) in zip(stages, choice):
        m = st.models[mi]
        total += m.fixed_flops + m.flops_per_item * st.item_scales[si]
    return total


def generate_action_chains(stages: Sequence[StageSpec]) -> ActionChainSet:
    """Cartesian-product generator (paper step 1, Figure 2).

    Downstream stages never score more items than the upstream stage kept,
    so combinations with n_{k+1} > n_k are pruned (the cascade hands at most
    n_k items to stage k+1).
    """
    stages = tuple(stages)
    per_stage = [
        list(itertools.product(range(st.n_models), range(st.n_scales)))
        for st in stages
    ]
    max_models = max(st.n_models for st in stages)
    q = stages[0].n_scale_groups
    if any(st.n_scale_groups != q for st in stages):
        raise ValueError("all stages must share Q (n_scale_groups)")

    idx_rows, names = [], []
    for combo in itertools.product(*per_stage):
        scales = [stages[k].item_scales[si] for k, (_, si) in enumerate(combo)]
        if any(scales[k + 1] > scales[k] for k in range(len(scales) - 1)):
            continue  # cascade monotonicity: can't rank more than received
        idx_rows.append([list(c) for c in combo])
        names.append("/".join(
            f"{stages[k].models[mi].name}@{stages[k].item_scales[si]}"
            for k, (mi, si) in enumerate(combo)))

    chain_idx = np.asarray(idx_rows, np.int32)  # (J, K, 2)
    j_total, k_total = chain_idx.shape[0], chain_idx.shape[1]

    costs = np.zeros((j_total,), np.float64)
    model_onehot = np.zeros((j_total, k_total, max_models), np.float32)
    scale_multihot = np.zeros((j_total, k_total, q), np.float32)
    scale_value = np.zeros((j_total, k_total), np.float32)
    for j in range(j_total):
        costs[j] = chain_cost(stages, chain_idx[j])
        for k, st in enumerate(stages):
            mi, si = chain_idx[j, k]
            model_onehot[j, k, mi] = 1.0
            scale_multihot[j, k] = st.multi_hot(int(si))
            scale_value[j, k] = st.item_scales[si]

    return ActionChainSet(
        stages=stages,
        chain_idx=chain_idx,
        costs=costs,
        model_onehot=model_onehot,
        scale_multihot=scale_multihot,
        scale_value=scale_value,
        names=names,
    )


# ---------------------------------------------------------------------------
# The paper's experimental chain space (§5.1 "Implementation of Action Chain")
# ---------------------------------------------------------------------------


def paper_stage_specs(
    *,
    dssm_flops: float = 13e3,
    ydnn_flops: float = 123e3,
    din_flops: float = 7020e3,
    dien_flops: float = 7098e3,
    n2: Sequence[int] = (800, 900, 1000, 1100, 1200, 1300, 1400, 1500),
    n3: Sequence[int] = (60, 80, 100, 120, 140, 160, 180, 200),
    q: int = 4,
) -> tuple[StageSpec, ...]:
    """DSSM (fixed) -> YDNN@n2 -> {DIN|DIEN}@n3, FLOPs from paper Table 1.

    The recall stage {DSSM, n_1} has fixed computation and is omitted from
    the decision space exactly as in the paper; we keep it as a stage with a
    single (model, scale) choice so the cascade engine still runs it.
    """
    recall = StageSpec(
        name="recall",
        models=(ModelInstance("DSSM", dssm_flops, auc=0.525),),
        item_scales=(4000,),
        n_scale_groups=q,
    )
    prerank = StageSpec(
        name="prerank",
        models=(ModelInstance("YDNN", ydnn_flops, auc=0.581),),
        item_scales=tuple(n2),
        n_scale_groups=q,
    )
    rank = StageSpec(
        name="rank",
        models=(
            ModelInstance("DIN", din_flops, auc=0.639),
            ModelInstance("DIEN", dien_flops, auc=0.641),
        ),
        item_scales=tuple(n3),
        n_scale_groups=q,
    )
    return (recall, prerank, rank)
