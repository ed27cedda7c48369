"""GreenFlow facade: the hybrid online-nearline allocator (paper Fig. 2).

Ties together the chain set (step 1), the reward model and cost measure
(step 2), the dynamic primal-dual (step 3, nearline) and the Eq. 10
decisions (online).  The allocator itself consumes compute (the paper
quantifies +3~8% FLOPs); ``self_cost_flops`` meters the reward-model
forward so PFEC reports include the overhead (Table 5 "Additional
Cost").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.action_chain import ActionChainSet
from repro_torch.core.budget import BudgetController
from repro_torch.core.flops import mlp_flops
from repro_torch.core.pfec import PFECReport, pfec_report
from repro_torch.core.primal_dual import DualDescentConfig
from repro_torch.core.reward_model import (N_BASIS, RewardModelConfig,
                                           denormalize_rewards,
                                           reward_matrix)


@dataclass
class GreenFlowAllocator:
    """``reward_params`` lie on the device the scoring runs on."""

    chains: ActionChainSet
    reward_params: dict
    reward_cfg: RewardModelConfig
    budget_per_window: float
    dual_cfg: DualDescentConfig = field(default_factory=DualDescentConfig)
    guard: bool = True

    def __post_init__(self):
        self.controller = BudgetController(
            self.chains, self.budget_per_window, self.dual_cfg, self.guard)
        dev = self.reward_params["cells"][0]["model_emb"].device
        self._chain_mo = torch.as_tensor(self.chains.model_onehot,
                                         device=dev)
        self._chain_sh = torch.as_tensor(self.chains.scale_multihot,
                                         device=dev)
        self._total_self_flops = 0.0
        self._total_spend = 0.0
        self._n_requests = 0

    # -- step 2: reward scores for a window of requests ---------------------
    @torch.no_grad()
    def score(self, raw_context: np.ndarray):
        ctx = torch.as_tensor(np.asarray(raw_context, np.float32),
                              device=self._chain_mo.device)
        self._total_self_flops += self.self_cost_flops(ctx.shape[0])
        r = reward_matrix(self.reward_params, self.reward_cfg, ctx,
                          self._chain_mo, self._chain_sh)
        # ratio-normalized training: predictions scale back to revenue
        # units before they meet chain costs
        return denormalize_rewards(self.reward_params, r)

    # -- steps 3+4: allocate one window --------------------------------------
    def allocate_window(self, raw_context: np.ndarray) -> np.ndarray:
        decisions = self.controller.step_window(self.score(raw_context))
        self._total_spend += float(self.chains.costs[decisions].sum())
        self._n_requests += len(decisions)
        return decisions

    # -- PFEC accounting ------------------------------------------------------
    def self_cost_flops(self, n_requests: int) -> float:
        """FLOPs of GreenFlow itself: encoder + K cells x J chains/request."""
        cfg = self.reward_cfg
        enc = mlp_flops([cfg.d_context, *cfg.encoder_hidden, cfg.d_feature])
        d_in = cfg.d_state + cfg.d_feature + cfg.d_model_emb
        cell = (mlp_flops([d_in, cfg.d_hidden, cfg.d_hidden])
                + mlp_flops([cfg.d_hidden, cfg.d_state])
                + mlp_flops([cfg.d_hidden, N_BASIS])
                + mlp_flops([cfg.d_hidden, N_BASIS * cfg.n_scale_groups]))
        per_request = enc + cfg.n_stages * cell * self.chains.n_chains
        return per_request * n_requests

    def report(self, clicks: float) -> PFECReport:
        return pfec_report(
            clicks=clicks,
            flops=self._total_spend,
            n_requests=self._n_requests,
            overhead_flops=self._total_self_flops,
            overhead_frac=self._total_self_flops / max(self._total_spend, 1.0),
            lam=float(self.controller.pd.lam),
        )

    @property
    def lam(self) -> float:
        return float(self.controller.pd.lam)
