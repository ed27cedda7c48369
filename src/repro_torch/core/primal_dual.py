"""Multi-price allocator core (paper §4.3, Algorithm 1).

With one global budget the Lagrangian dual is a scalar price lambda and
the inner max decomposes per request:

    x_ij = 1  iff  j = argmax_j (R_ij - lambda * c_j)          (Eq. 10)

The general form prices K >= 1 constraints at once (tenants, serving
regions, or both):

    x_im = 1  iff  m = argmax_m (R_im - sum_k lam_k * A_imk)

where m indexes options (chains, or chains x serving regions) and the
consumption factors as A_imk = member_ik * C_mk with

    C      (M, K)  cost map: what option m draws from constraint k;
    member (I, K)  which constraints request i is subject to (None =
                   every request subject to all K).

Every function accepts both forms: a scalar ``lam`` (a number or a
0-dim tensor) with (M,) costs, or a (K,) ``lam`` with an (M, K) cost
map (an (M, 1) column spans K constraints through ``member``).  The
vector path reduces per constraint column - one (I,) sum each, never a
(I, K) axis reduction - and forms its price term as an ordered sum of
per-column products, so with K = 1 it runs the scalar path's exact
float program (bitwise equal), and with a one-hot or two-hot
membership every price is exact in any summation order.

  * ``allocate``      - Eq. 10 decisions for a batch of requests;
  * ``consumption``   - per-constraint spend at a given price;
  * ``dual_descent``  - Algorithm 1's projected subgradient steps on the
    device: a fixed number of iterations with no host read, so a CUDA
    graph captures the whole loop;
  * ``dual_bisect``   - an exact scalar oracle (single constraint);
  * ``window_step``   - the host-loop window body (decide -> NumPy
    guard -> dual update) the budget controller runs;
  * ``DynamicPrimalDual`` - the nearline price tracker.

``consumption`` and ``dual_descent`` take ``n_shards``: over a request
mesh of S > 1 shards every sum over requests (each spend, ``n_eff`` and
``n_k``) is the shard-ordered fold of per-shard partials, as the JAX
package's sharded pass forms it (``distributed.sharding``); one shard
runs the unsharded sums themselves.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_sum


@dataclass(frozen=True)
class DualDescentConfig:
    max_iters: int = 200  # L in Algorithm 1
    step_size: float = 1.0  # eta (normalized internally, see below)
    step_decay: float = 0.999
    lam_init: float = 0.0


def _is_vector(lam) -> bool:
    return isinstance(lam, torch.Tensor) and lam.dim() > 0


def _as_cost_map(costs):
    """(M,) or (M, K) costs -> (M, K) cost map."""
    return costs if costs.dim() == 2 else costs[:, None]


def _option_prices(costs, lam, member):
    """The Lagrangian price term: (M,) without ``member``, (I, M) with.

    sum_k lam_k * member_ik * C_mk as an ordered sum over k of
    per-column products (column k of an (M, 1) map is its only column).
    """
    cm = _as_cost_map(costs)
    k_n = int(lam.shape[0])
    if member is None and cm.shape[1] != k_n:
        raise ValueError(  # an (M, 1) column spans K only through member
            f"cost map with {cm.shape[1]} columns cannot be priced by "
            f"{k_n} duals without a member matrix")
    price = None
    for k in range(k_n):
        col = cm[:, min(k, cm.shape[1] - 1)] * lam[k]
        term = col if member is None else member[:, k, None] * col[None, :]
        price = term if price is None else price + term
    return price


def allocate(rewards, costs, lam, member=None):
    """Eq. 10: rewards (I, M); costs (M,) with a scalar ``lam``, or
    (M, K) with a (K,) ``lam`` and optional ``member`` (I, K).  Returns
    (I,) int32 option indices (first index on ties)."""
    if not _is_vector(lam):
        score = rewards - lam * costs[None, :]
    else:
        price = _option_prices(costs, lam, member)
        score = rewards - (price if price.dim() == 2 else price[None, :])
    return torch.argmax(score, dim=1).to(torch.int32)


def consumption(rewards, costs, lam, mask=None, *, member=None,
                n_shards: int = 1):
    """Spend if ``lam`` is the price: the total with a scalar ``lam``,
    the (K,) per-constraint spend sum_i member_ik C[m*_i, k] with a
    vector one; mask (I,) zeroes padded requests."""
    j_star = allocate(rewards, costs, lam, member).long()
    if not _is_vector(lam):
        taken = costs[j_star]
        return shard_sum(taken if mask is None else taken * mask, n_shards)
    taken = _as_cost_map(costs)[j_star]  # (I, K) or (I, 1)
    cols = []
    for k in range(int(lam.shape[0])):
        tk = taken[:, min(k, taken.shape[1] - 1)]
        if member is not None:
            tk = tk * member[:, k]
        cols.append(shard_sum(tk if mask is None else tk * mask, n_shards))
    return torch.stack(cols)


def realized_reward(rewards, j_star):
    return torch.sum(torch.gather(rewards, 1, j_star.long()[:, None]))


def dual_descent(rewards, costs, budget, lam0, *, mask=None, member=None,
                 max_iters: int = 200, step_size: float = 1.0,
                 step_decay: float = 0.999, n_shards: int = 1):
    """Algorithm 1 inner loop (steps 5-9), vectorized over requests.

    A scalar ``lam0`` and ``budget`` run the single-price update; a (K,)
    ``lam0`` with a (K,) ``budget`` descends all K prices jointly, each
    on its own subgradient B_k - used_k.  The raw subgradient has the
    scale of the budget while useful prices have the scale of reward per
    unit cost, so the step is normalized by n_k * mean_k(cost)^2 (n_k =
    valid requests subject to constraint k, floored at 1 so an empty
    window cannot slam the price to 0; mean_k over the options that draw
    from k).  The vector norm is the scalar expression per column times
    a sparsity correction (M / cnt_k)^2, exactly 1.0 for a fully active
    column, so K = 1 reproduces the scalar norm bit for bit.

    ``budget`` and ``lam0`` are numbers or device tensors; numbers enter
    by fill kernels, never by a host copy.  Returns (lam, gaps (L,) or
    (L, K)) as device tensors."""
    costs = costs.to(torch.float32)
    rewards = rewards.to(torch.float32)
    dev = rewards.device
    f32 = torch.float32

    def as_tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=f32)
        return torch.full((), float(x), dtype=f32, device=dev)

    if mask is None:
        n_eff = as_tensor(rewards.shape[0])
    else:
        n_eff = shard_sum(mask.to(f32), n_shards)
    lam = as_tensor(lam0).clone()
    budget = as_tensor(budget)
    if not _is_vector(lam):
        norm = torch.clamp(n_eff, min=1.0) * torch.mean(costs) ** 2 + 1e-30
    else:
        cm = _as_cost_map(costs)
        k_n = int(lam.shape[0])
        if member is not None:
            m = member if mask is None else member * mask[:, None]
            n_k = torch.stack([shard_sum(m[:, k], n_shards)
                               for k in range(k_n)])
        else:
            n_k = n_eff
        cols = [cm[:, min(k, cm.shape[1] - 1)] for k in range(k_n)]
        mean = torch.stack([torch.mean(c) for c in cols])
        cnt = torch.clamp(torch.stack(
            [torch.sum((c > 0).to(f32)) for c in cols]), min=1.0)
        corr = (cm.shape[0] / cnt) ** 2
        base = torch.clamp(n_k, min=1.0) * mean ** 2 + 1e-30
        norm = base * corr
    eta = as_tensor(step_size)
    gaps = []
    for _ in range(max_iters):
        gap = budget - consumption(rewards, costs, lam, mask, member=member,
                                   n_shards=n_shards)
        lam = torch.clamp(lam - eta * gap / norm, min=0.0)
        eta = eta * step_decay
        gaps.append(gap)
    trace = torch.stack(gaps) if gaps else torch.zeros(0, device=dev)
    return lam, trace


def dual_bisect(rewards, costs, budget: float, *, iters: int = 64,
                lam_hi_init: float | None = None):
    """Smallest lambda >= 0 with consumption(lambda) <= budget.

    Single constraint: consumption is non-increasing in lambda, so
    bisection is exact up to float resolution; 0 when even lambda = 0
    fits.  The upper bound is the price at which every request takes
    its cheapest chain, from the smallest positive cost gap."""
    rewards = rewards.to(torch.float32)
    costs = costs.to(torch.float32)
    dev = rewards.device

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    if lam_hi_init is None:
        r_span = torch.max(rewards) - torch.min(rewards)
        gaps = torch.diff(torch.sort(costs).values)
        pos = gaps[gaps > 0]
        min_gap = torch.min(pos) if pos.numel() else torch.max(costs)
        lam_hi = r_span / torch.clamp(min_gap, min=1e-30) + 1.0
    else:
        lam_hi = f32(lam_hi_init)
    lo, hi = f32(0.0), lam_hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fits = consumption(rewards, costs, mid) <= budget
        lo, hi = torch.where(fits, lo, mid), torch.where(fits, mid, hi)
    fits0 = consumption(rewards, costs, f32(0.0)) <= budget
    return torch.where(fits0, f32(0.0), hi)


def window_step(rewards, costs, budget: float, lam, *, cheap: int,
                guard: bool = True, cfg: DualDescentConfig | None = None):
    """One host-loop serving window in the scalar form: Eq. 10 decide ->
    tail-reserve guard (NumPy) -> Algorithm 1 price update.  ``rewards``
    is a tensor (its device runs the arithmetic) or an array.  Returns
    ``(decisions, downgraded, spend, lam_new)`` with ``decisions`` a host
    ndarray and ``lam_new`` a 0-dim tensor."""
    from repro_torch.serving.guard import downgrade_guard_np

    cfg = cfg or DualDescentConfig()
    costs = np.asarray(costs)
    rewards_t = torch.as_tensor(rewards)
    costs_t = torch.as_tensor(costs, dtype=torch.float32,
                              device=rewards_t.device)
    decisions = allocate(rewards_t, costs_t, lam).cpu().numpy()
    downgraded = 0
    spend = float(np.sum(costs[decisions]))
    if guard:
        decisions, downgraded, spend = downgrade_guard_np(
            decisions, costs, budget, cheap)
    lam_new, _ = dual_descent(
        rewards_t, costs_t, budget, lam, max_iters=cfg.max_iters,
        step_size=cfg.step_size, step_decay=cfg.step_decay)
    return decisions, downgraded, spend, lam_new


class DynamicPrimalDual:
    """Nearline dual-price tracker: every window, L descent steps warm
    started at lambda_{t-1} publish lambda_t, which the next window's
    Eq. 10 decisions use (near-optimal under i.i.d. arrivals)."""

    def __init__(self, costs, budget_per_window: float,
                 cfg: DualDescentConfig | None = None):
        self.costs = torch.as_tensor(np.asarray(costs), dtype=torch.float32)
        self.budget = float(budget_per_window)
        self.cfg = cfg or DualDescentConfig()
        self.lam = torch.tensor(self.cfg.lam_init, dtype=torch.float32)
        self.history: list[float] = []

    def update(self, rewards) -> float:
        """One nearline window: returns the new published price."""
        rewards = torch.as_tensor(rewards)
        lam, _ = dual_descent(
            rewards, self.costs.to(rewards.device), self.budget, self.lam,
            max_iters=self.cfg.max_iters, step_size=self.cfg.step_size,
            step_decay=self.cfg.step_decay)
        self.lam = lam
        self.history.append(float(lam))
        return float(lam)

    def decide(self, rewards):
        """Online Eq. 10 with the latest published price."""
        rewards = torch.as_tensor(rewards)
        return allocate(rewards, self.costs.to(rewards.device),
                        self.lam.to(rewards.device))

    def set_budget(self, budget: float):
        self.budget = float(budget)
