"""ServingPipeline: the score -> decide -> guard -> execute window pass.

One window of the paper's online system, on the device:

  1. reward scoring   - ``reward_matrix_grouped`` (model-prefix dedup);
  2. Eq. 10 decisions - ``allocate`` at the window's entry price;
  3. downgrade guard  - ``serving.guard.downgrade_guard`` (cumsum
     tail-reserve walk, mask-aware);
  4. cascade execute  - CompactPlan threshold arithmetic through the
     ``cascade_truncate`` kernel;
  5. nearline update  - ``dual_descent`` (Algorithm 1) on the window's
     rewards publishes the next window's price.

Steps 1-4 are the response path; step 5 is nearline: it reuses the
reward matrix on the device and nothing reads it back on the host.  The
price lives in one device buffer that the update overwrites in place
(``self.lam``); records hold device copies.

Windows are padded to a bucket size (multiples of ``pad_quantum``,
linear or power-of-two steps) with a validity mask, so a traffic spike
reuses a handful of shapes.  Only the plain ``[GlobalAxis]`` spec is
supported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.cascade.engine import _revenue_compact
from repro_torch.core.primal_dual import (DualDescentConfig, allocate,
                                          dual_descent)
from repro_torch.core.reward_model import (RewardModelConfig,
                                           chain_prefix_plan,
                                           denormalize_rewards,
                                           reward_matrix_grouped)
from repro_torch.device import resolve_device
from repro_torch.serving.guard import downgrade_guard
from repro_torch.serving.spec import ConstraintSpec, GlobalAxis


def window_layout(n: int, b: int):
    """Padded layout of an n-request window in a b-slot bucket:
    ``(perm, valid)`` - ``perm[pos]`` is the original request index at
    padded position ``pos`` (0 on padding), ``valid`` masks real ones."""
    valid = np.zeros(b, np.float32)
    valid[:n] = 1.0
    perm = np.concatenate([np.arange(n, dtype=np.int64),
                           np.zeros(b - n, np.int64)])
    return perm, valid


@dataclass
class WindowResult:
    """One served window; tensors stay on the device until read."""

    n_valid: int
    budget: float
    lam_before: torch.Tensor
    lam_after: torch.Tensor
    decisions: torch.Tensor  # (b,) padded chain index
    revenue: torch.Tensor  # (b,) padded (0 on padding)
    spend: torch.Tensor
    downgraded: torch.Tensor
    valid: np.ndarray  # (b,) 1.0 on real requests
    flops: torch.Tensor | None = None  # realized FLOPs
    h2d_bytes: int = 0
    prep_ms: float = 0.0  # host chunk production (set by run_stream)

    @property
    def decisions_np(self) -> np.ndarray:
        return self.decisions.cpu().numpy()[self.valid > 0]

    @property
    def revenue_np(self) -> np.ndarray:
        return self.revenue.cpu().numpy()[self.valid > 0]


class ServingPipeline:
    """Per-window serving pass over a streaming universe.

    ``server`` is a ``StreamUniverse`` (chain set + compact layout);
    every ``serve_window`` brings a chunk's tables.  ``reward_params``
    is the reward model's parameter tree on ``device`` (with
    ``label_norm`` when trained on ratio labels).  ``device`` defaults
    to the card and raises without one.
    """

    def __init__(self, server, reward_params: dict,
                 reward_cfg: RewardModelConfig, budget_per_window: float,
                 *, dual_cfg: DualDescentConfig | None = None,
                 pad_quantum: int = 32, bucketing: str = "linear",
                 spec: ConstraintSpec | None = None, device=None):
        self.device = dev = resolve_device(device)
        if spec is None:
            spec = ConstraintSpec([GlobalAxis(float(budget_per_window))])
        self.spec = spec
        self._cs = spec.compile()
        self.budget = self._cs.total_budget
        self.server = server
        self.chains = server.chains
        self.reward_params = reward_params
        self.reward_cfg = reward_cfg
        self.dual_cfg = dual_cfg or DualDescentConfig()
        if bucketing not in ("linear", "pow2"):
            raise ValueError(f"bucketing must be 'linear' or 'pow2', "
                             f"got {bucketing!r}")
        self.bucketing = bucketing
        self.pad_quantum = int(pad_quantum)
        if server.compact is None:
            raise ValueError("the pipeline needs the compact (k3) layout")
        chains = self.chains
        self._prefix_plan = chain_prefix_plan(chains.chain_idx[:, :, 0])
        self._sh = torch.as_tensor(chains.scale_multihot, device=dev)
        self._costs = torch.as_tensor(chains.costs, dtype=torch.float32,
                                      device=dev)
        self._cheap = int(chains.cheapest())
        c = server.compact
        self._g_of = torch.as_tensor(c.group_of_chain, device=dev)
        self._n3_of = torch.as_tensor(c.n3_of_chain, device=dev)
        self._expose = int(c.expose)
        self._cap = int(c.cap)
        # the nearline price: one device buffer, overwritten in place
        self.lam = torch.zeros((), dtype=torch.float32, device=dev)
        self.stats: list[WindowResult] = []

    def _bucket(self, n: int) -> int:
        """Pad target: the next multiple of ``pad_quantum`` (linear) or
        the next power-of-two multiple of it (pow2)."""
        q = self.pad_quantum
        b = max(q, ((n + q - 1) // q) * q)
        if self.bucketing == "pow2":
            b = q * (1 << max(0, (b + q - 1) // q - 1).bit_length())
        return b

    def _pad_chunk_tables(self, tables: dict, n: int, b: int):
        """A chunk's (G, n, cap) tables -> (G, b, cap) on the device;
        padded requests gather row 0 and are masked, so the sentinel
        rows only keep the shape bucket-stable."""
        p = torch.as_tensor(tables["p"], device=self.device)
        ck = torch.as_tensor(tables["ck"], device=self.device)
        if p.shape[1] != n:
            raise ValueError(f"chunk tables carry {p.shape[1]} rows for "
                             f"a {n}-request window")
        p = p.to(torch.int32)
        ck = ck.to(torch.float32)
        if b != n:
            g_n, _, cap = p.shape
            p = torch.cat([p, torch.full((g_n, b - n, cap), self._cap,
                                         dtype=torch.int32,
                                         device=self.device)], dim=1)
            ck = torch.cat([ck, torch.zeros((g_n, b - n, cap),
                                            device=self.device)], dim=1)
        return p.contiguous(), ck.contiguous()

    def _rewards(self, ctx):
        """(b, J) predicted rewards of the window's padded contexts."""
        return denormalize_rewards(self.reward_params, reward_matrix_grouped(
            self.reward_params, self.reward_cfg, ctx, self._sh,
            self._prefix_plan))

    @torch.no_grad()
    def _main(self, p, ck, ctx, rows, valid, lam, padded: bool):
        """Response path: score -> decide -> guard -> execute."""
        rewards = self._rewards(ctx)
        dec = allocate(rewards, self._costs, lam)
        dec, dg, spend = downgrade_guard(dec, self._costs, self.budget,
                                         self._cheap,
                                         valid if padded else None)
        d = dec.long()
        rev = _revenue_compact(p, ck, self._g_of[d], rows, self._n3_of[d],
                               expose=self._expose) * valid
        return rewards, dec, rev, spend, dg

    def serve_window(self, ctx: np.ndarray, rows: np.ndarray, *,
                     tables: dict, lam=None,
                     update_lam: bool = True) -> WindowResult:
        """Serve one window: ctx (n, d_context) raw contexts, rows (n,)
        LOCAL indices into the chunk ``tables``.  Decisions use ``lam``
        (default: the nearline price lambda_{t-1}); the pass then
        publishes lambda_t unless ``update_lam=False``."""
        dev = self.device
        n = len(rows)
        if n == 0:  # zero-arrival window: nothing to serve or learn from
            lam_rec = self.lam.clone()
            zero = torch.zeros((), device=dev)
            res = WindowResult(
                n_valid=0, budget=self.budget, lam_before=lam_rec,
                lam_after=lam_rec,
                decisions=torch.zeros(0, dtype=torch.int32, device=dev),
                revenue=torch.zeros(0, device=dev), spend=zero,
                downgraded=torch.zeros((), dtype=torch.int32, device=dev),
                valid=np.zeros(0, np.float32), flops=zero)
            self.stats.append(res)
            return res
        ctx = np.asarray(ctx, np.float32)
        b = self._bucket(n)
        perm, valid = window_layout(n, b)
        if b != n:
            ctx_p = np.zeros((b, ctx.shape[1]), np.float32)
            ctx_p[:n] = ctx
            ctx = ctx_p
        p, ck = self._pad_chunk_tables(tables, n, b)
        ctx_t = torch.from_numpy(ctx).to(dev)
        rows_t = torch.from_numpy(perm).to(dev)  # gather within the chunk
        valid_t = torch.from_numpy(valid).to(dev)
        h2d = ctx.nbytes + perm.nbytes + valid.nbytes
        lam_in = (self.lam if lam is None
                  else torch.tensor(float(lam), dtype=torch.float32,
                                    device=dev))
        lam_before = lam_in.clone()
        with record_function("window/main"):
            rewards, dec, rev, spend, dg = self._main(
                p, ck, ctx_t, rows_t, valid_t, lam_in, b != n)
        cfg = self.dual_cfg
        with torch.no_grad(), record_function("window/dual"):
            lam_new, _ = dual_descent(
                rewards, self._costs, self.budget, lam_in,
                mask=valid_t if b != n else None, max_iters=cfg.max_iters,
                step_size=cfg.step_size, step_decay=cfg.step_decay)
        if update_lam:
            self.lam.copy_(lam_new)  # in place: the price buffer is reused
            lam_after = self.lam.clone()
        else:
            lam_after = lam_new
        res = WindowResult(
            n_valid=n, budget=self.budget, lam_before=lam_before,
            lam_after=lam_after, decisions=dec, revenue=rev, spend=spend,
            downgraded=dg, valid=valid,
            flops=torch.sum(self._costs[dec.long()] * valid_t),
            h2d_bytes=int(h2d))
        self.stats.append(res)
        return res
