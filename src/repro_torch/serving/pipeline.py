"""ServingPipeline: the score -> decide -> guard -> execute window pass.

One window of the online system, on the device:

  1. reward scoring   - ``reward_matrix_grouped`` (model-prefix dedup);
  2. Eq. 10 decisions - ``allocate`` at the window's entry price(s);
  3. downgrade guard  - ``serving.guard`` (cumsum tail-reserve walks,
     mask-aware, per-constraint budgets);
  4. cascade execute  - CompactPlan threshold arithmetic through the
     ``cascade_truncate`` kernel;
  5. nearline update  - ``dual_descent`` (Algorithm 1) on the window's
     rewards publishes the next window's price(s).

Steps 1-4 are the response path; step 5 is nearline: it reuses the
reward matrix on the device and nothing reads it back on the host.  The
price lives in one device buffer that the update overwrites in place
(``self.lam``); records hold device copies.

What is budgeted is declared by a ``serving.spec.ConstraintSpec``
(``ServingPipeline.from_spec``):

  * [GlobalAxis]              - one budget, one scalar price (the paper);
  * [TenantAxis(shared)]      - T equal-size tenant blocks a window, one
    price on the total budget, the guard capping each tenant's block;
  * [TenantAxis(priced)]      - a (T,) price vector, each tenant's price
    on its own budget;
  * [RegionAxis]              - the geo router: each request chooses
    (chain, serving region) at costs c_{j,r} = flops_j * scale_r, (R,)
    budgets and prices, the guard walking each region;
  * [TenantAxis + RegionAxis] - tenant and region budgets together: a
    tenant-t request pays (lam_tenant[t] + lam_region[r]) * c_{j,r}
    ((T + R,) prices when tenants are priced, (R,) when shared), and the
    guard chains a tenant walk with a region walk.

The server is either a streaming universe (``StreamUniverse``: every
window brings its chunk's (G, n, cap) tables and ``rows`` index them)
or a materialized ``CascadeServer`` (``tables`` omitted: ``rows`` index
its users and the window reads its CompactPlan).

Windows are padded to a bucket size (multiples of ``pad_quantum``,
linear or power-of-two steps) with a validity mask; tenant windows pad
each tenant block on its own (``window_layout``).  Each bucket
``(b, padded)`` gets one window program: static input buffers
(contexts, rows, validity, tenant map, tables, the entry price, and the
window's budgets and cost scales for the response path and for the
dual), the response path captured as the ``window/main`` CUDA graph and
the dual loop as ``window/dual``, replayed on every later window of the
bucket (``graphs.Program``).  Every per-window number enters through
those buffers, so a replay never reuses an earlier window's budget.
``WindowResult.compiles`` counts the captures a window caused - zero on
a warm bucket.  ``graphs=False`` runs the same programs eagerly through
the same buffers: the reference the captured windows are held to, and
what the CPU runs.

The spends the window reports are ordered masked sums - one (b,) sum a
constraint, never a matmul or an atomic scatter - so they are exact
wherever the costs make every f32 sum exact and repeat bit for bit on
the card.

Request mesh (``mesh``, a ``launch.mesh.RequestMesh`` of S shards over
P processes): the pad quantum becomes lcm(pad_quantum, S), every window
splits into S shards of b / S rows, and the window runs as three
programs a bucket.  ``window/score`` scores this process's shards one at
a time, each at its b / S rows, so a shard's rewards do not depend on
where it runs; with P > 1 the processes then gather the window's (b, J)
rewards through the host over the mesh's gloo group, one host sync a
window (single-process runs, ``--shards S`` included, have none).
``window/main`` runs the cross-shard seams - Eq. 10, the guard walks and
the region flow split - over all S shards on every process, every
cross-shard sum a shard-ordered fold of per-shard partials
(``distributed.sharding``), and the truncation kernel over this
process's rows, shard by shard; ``window/dual`` runs the dual loop over
all S shards the same way.  Every process so computes the same prices,
spends and decisions, bit for bit, and the same as one process at the
same S; each process reports the decisions, revenue and regions of its
own rows (``WindowResult.rows_global``) and the replicated prices and
spends; with an ``obs`` the ``gather`` span times the gather, the wait
for this process's own scoring included (the copy to the host waits
for it).  A multi-process pipeline serves host slices
(``serve_window(..., shard=)``, from a
``distributed.multihost.MultihostSource``).  ``mesh=None``, the default,
serves as before: two programs a bucket, the scoring inside
``window/main``.
"""
from __future__ import annotations

import math
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
                                           device_prefix_plan,
                                           reward_matrix_grouped)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (gather_shards, shard_prefix,
                                              shard_sum)
from repro_torch.graphs import Program, consume, record_event, side_stream
from repro_torch.launch.mesh import mesh_local_shards, mesh_num_shards
from repro_torch.obs import get_obs
from repro_torch.serving.guard import downgrade_guard, downgrade_guard_chain
from repro_torch.serving.spec import ConstraintSpec, spec_from_legacy


def window_layout(n: int, b: int, t_n: int | None = None):
    """The padded layout of an n-request window in a b-slot bucket:
    ``(perm, valid, k_of)``.  ``perm[pos]`` is the original request
    index at padded position ``pos`` (0 on padding), ``valid`` masks
    real requests and ``k_of`` maps positions to tenants (None without
    tenants).  Plain windows pad at the end; tenant windows carry
    ``t_n`` equal blocks of ``b // t_n`` slots, each padded at its end,
    so every tenant's guard walk stays aligned with its budget."""
    if t_n is None:
        valid = np.zeros(b, np.float32)
        valid[:n] = 1.0
        perm = np.concatenate([np.arange(n, dtype=np.int64),
                               np.zeros(b - n, np.int64)])
        return perm, valid, None
    if n % t_n:
        raise ValueError(f"window size {n} not divisible by "
                         f"{t_n} tenants")
    if b % t_n:
        raise ValueError(f"bucket {b} not divisible by {t_n} tenants")
    n_t, bt = n // t_n, b // t_n
    valid = np.zeros((t_n, bt), np.float32)
    valid[:, :n_t] = 1.0
    perm = np.zeros((t_n, bt), np.int64)
    perm[:, :n_t] = (np.arange(t_n)[:, None] * n_t
                     + np.arange(n_t)[None, :])
    k_of = np.repeat(np.arange(t_n, dtype=np.int64), bt)
    return perm.reshape(b), valid.reshape(b), k_of


@dataclass
class WindowResult:
    """One served window; tensors stay on the device until read, and are
    the window's own (copies of the program's static outputs).

    ``budget`` and ``spend`` are in the window's cost units (FLOPs, or
    gCO2e under a carbon ``cost_scale``); ``flops`` is always the
    realized FLOPs.  ``lam_before``/``lam_after`` are scalars in the
    single-price modes and (K,) vectors otherwise (``k_names`` order).
    With tenants and regions ``tr_spend`` is the (T, R) spend whose
    marginals are ``tenant_spend`` and ``region_spend``.

    In a multi-process window ``decisions``, ``revenue``, ``regions`` and
    ``valid`` cover this process's rows, ``rows_global`` their rows in the
    padded window; prices and spends are the window's, alike on every
    process."""

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
    cost_scale: float = 1.0  # cost units per FLOP (mean over regions)
    tenant_spend: torch.Tensor | None = None  # (T,)
    regions: torch.Tensor | None = None  # (b,) serving region
    region_spend: torch.Tensor | None = None  # (R,)
    tr_spend: torch.Tensor | None = None  # (T, R)
    k_budget: np.ndarray | None = None  # the window's budget vector
    compiles: int = 0  # program captures this window caused (0 = warm)
    bucket: tuple | None = None  # the (b, padded) program key
    h2d_bytes: int = 0
    prep_ms: float = 0.0  # host chunk production (set by run_stream)
    stall_ms: float = 0.0  # wait for a prefetched chunk (run_stream)
    rows_global: np.ndarray | None = None  # this process's padded rows

    @property
    def decisions_np(self) -> np.ndarray:
        return self.decisions.cpu().numpy()[self.valid > 0]

    @property
    def revenue_np(self) -> np.ndarray:
        return self.revenue.cpu().numpy()[self.valid > 0]

    @property
    def regions_np(self) -> np.ndarray | None:
        if self.regions is None:
            return None
        return self.regions.cpu().numpy()[self.valid > 0]


class _WindowProgram:
    """One padding bucket's window program: static inputs, two pinned
    staging slots used in turn, and the ``window/main`` and
    ``window/dual`` programs (with a mesh also ``window/score``) on one
    graph pool.

    The per-window numbers live in one device vector ``knobs`` (the
    budget, cost scale, dual budget and dual cost scale, and a price
    given on the host), filled by one pinned copy a window; ``budget``,
    ``scale``, ``d_budget`` and ``d_scale`` are views of it.  Contexts,
    rows and tables hold this process's rows ``[lo, hi)`` of the padded
    window (all b rows unless the pipeline spans processes); ``valid``,
    ``k_of`` and ``rewards`` the whole window."""

    def __init__(self, pipe: "ServingPipeline", b: int, padded: bool,
                 chunked: bool):
        dev = pipe.device
        cs = pipe._cs
        d = pipe.reward_cfg.d_context
        j_n = pipe.chains.n_chains
        if pipe.multihost:
            self.lo, self.hi = _host_rows(pipe.mesh, b)
        else:
            self.lo, self.hi = 0, b
        rows_n = self.hi - self.lo
        self.ctx = torch.zeros((rows_n, d), device=dev)
        self.rows = torch.zeros(rows_n, dtype=torch.int64, device=dev)
        self.valid = torch.zeros(b, device=dev)
        self.k_of = torch.zeros(b, dtype=torch.int64, device=dev)
        if chunked:
            g_n, cap = len(pipe.server.compact.p_sorted), pipe._cap
            self.p = torch.full((g_n, rows_n, cap), cap, dtype=torch.int32,
                                device=dev)
            self.ck = torch.zeros((g_n, rows_n, cap), device=dev)
        else:  # the materialized server's tables, read by row
            self.p, self.ck = pipe._tables["p"], pipe._tables["ck"]
        self.lam = torch.zeros(pipe.lam.shape, device=dev)
        self.rewards = torch.zeros((b, j_n), device=dev)
        nb = 0 if cs.mode == "plain" else cs.budget_len()
        ns = 0 if cs.regions is None else cs.r_n
        self._knob_sizes = (nb, ns) * 2
        width = 2 * (max(nb, 1) + max(ns, 1)) + max(1, pipe.lam.numel())
        self.knobs = torch.zeros(width, device=dev)
        views, at = [], 0
        for n in (nb, ns, nb, ns):
            views.append(self.knobs[at] if n == 0
                         else self.knobs[at:at + n])
            at += max(n, 1)
        self.budget, self.scale, self.d_budget, self.d_scale = views
        self._lam_at = at
        pin = dev.type == "cuda"
        self._slots = [[torch.zeros((rows_n, d), pin_memory=pin),
                        torch.zeros(rows_n, dtype=torch.int64,
                                    pin_memory=pin),
                        torch.zeros(b, pin_memory=pin),
                        torch.zeros(b, dtype=torch.int64, pin_memory=pin),
                        torch.zeros(width, pin_memory=pin), None]
                       for _ in range(2)]
        self._turn = 0
        self.host_rows = self.host_all = None
        if pipe.multihost:
            # the rewards gather's host buffers: this process's rows and
            # every process's, in shard order
            world = pipe.mesh.world
            self.host_rows = torch.zeros((rows_n, j_n), pin_memory=pin)
            self.host_all = torch.zeros((world, rows_n, j_n),
                                        pin_memory=pin)
        capture = pipe.graphs and dev.type == "cuda"
        kw = dict(capture=capture, stream=pipe._capture_stream,
                  pool=torch.cuda.graph_pool_handle() if capture else None)
        self.programs = []
        if pipe.mesh is not None:
            self.score = Program(lambda: pipe._score(self), **kw)
            self.programs.append(self.score)
        self.main = Program(lambda: pipe._main(self, padded), **kw)
        self.dual = Program(lambda: pipe._dual(self, padded), **kw)
        self.programs += [self.main, self.dual]

    def builds(self) -> int:
        return sum(p.builds for p in self.programs)

    def load(self, ctx: np.ndarray, rows: np.ndarray, valid: np.ndarray,
             k_of, knobs: list, tables, lam) -> int:
        """Fill the static inputs for one window on the current stream:
        host arrays by pinned ``non_blocking`` copies (``knobs`` the
        budget, scale, dual budget and dual scale, each a number or a
        vector), the chunk tables (if any) by device copies with
        sentinel padding, and the price by a device copy, or from the
        host with the knobs.  Returns the bytes copied from the host."""
        slot = self._slots[self._turn]
        self._turn ^= 1
        if slot[5] is not None:
            slot[5].synchronize()  # this slot's last copies are done
        slot[0].numpy()[:] = ctx
        slot[1].numpy()[:] = rows
        slot[2].numpy()[:] = valid
        host = slot[4].numpy()
        at = 0
        for v, n in zip(knobs, self._knob_sizes):
            m = max(n, 1)
            host[at:at + m] = np.asarray(v, np.float32).reshape(m)
            at += m
        lam_host = not isinstance(lam, torch.Tensor)
        if lam_host:
            host[at:] = np.broadcast_to(np.asarray(lam, np.float32),
                                        self.lam.shape).reshape(-1)
        dsts = [self.ctx, self.rows, self.valid, self.knobs]
        srcs = [slot[0], slot[1], slot[2], slot[4]]
        if k_of is not None:
            slot[3].numpy()[:] = k_of
            dsts.append(self.k_of)
            srcs.append(slot[3])
        for dst, src in zip(dsts, srcs):
            dst.copy_(src, non_blocking=True)
        slot[5] = record_event(torch.cuda.current_stream()
                               if self.ctx.is_cuda else None)
        if tables is not None:
            p, ck = tables
            n = p.shape[1]
            self.p[:, :n].copy_(p)
            self.p[:, n:].fill_(self.p.shape[2])
            self.ck[:, :n].copy_(ck)
            self.ck[:, n:].zero_()
        if lam_host:
            self.lam.copy_(self.knobs[self._lam_at:].view(self.lam.shape))
        else:
            self.lam.copy_(lam)
        return sum(t.numel() * t.element_size() for t in srcs)


def _cat(parts: list):
    """The parts' rows in order; one part as it is, without a copy."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _host_rows(mesh, b: int) -> tuple[int, int]:
    """This process's rows [lo, hi) of a b-row window: its shards are
    contiguous."""
    per = b // mesh.n_shards
    return mesh.first_shard * per, (mesh.first_shard
                                    + mesh.local_shards) * per


class ServingPipeline:
    """Per-window serving pass over a streaming universe or a
    materialized ``CascadeServer``.

    ``reward_params`` is the reward model's parameter tree on ``device``
    (with ``label_norm`` when trained on ratio labels).  The keyword
    form (``budget_per_window``, ``tenant_budgets``/``tenant_mode``,
    ``n_regions``) builds its spec through ``spec_from_legacy``;
    ``spec`` overrides it.  ``device`` defaults to the card and raises
    without one.  ``graphs`` (default) captures each bucket's window
    program as CUDA graphs on the card; ``graphs=False`` runs the same
    programs eagerly (the reference).

    ``lam_init`` is the price the first window decides at (a (K,) fill
    with several prices); ``dual_cfg`` sets only the nearline update's
    steps.  ``guard=False`` serves the Eq. 10 decisions unguarded: no
    downgrade walk, ``downgraded`` 0 and the spend the decided costs of
    the valid requests.

    ``mesh`` (a ``launch.mesh.RequestMesh``) shards every window over S
    request shards (see the module docstring); a mesh that spans
    processes makes the pipeline serve host slices (``multihost``).

    ``ledger`` (a ``carbon.CarbonLedger``) parks every served
    ``WindowResult`` for lazy metering; ``obs`` (a ``repro_torch.obs.Obs``)
    records the host spans ``h2d``, ``dispatch`` and ``dual_update``
    around the window's loads and graph launches (with a mesh also
    ``score`` and ``gather``).  Neither reads a device value inside the
    window, and neither changes a number.
    """

    def __init__(self, server, reward_params: dict,
                 reward_cfg: RewardModelConfig, budget_per_window: float,
                 *, dual_cfg: DualDescentConfig | None = None,
                 pad_quantum: int = 32, bucketing: str = "linear",
                 tenant_budgets=None, tenant_mode: str = "shared",
                 n_regions: int | None = None,
                 spec: ConstraintSpec | None = None, graphs: bool = True,
                 guard: bool = True, lam_init: float = 0.0,
                 ledger=None, obs=None, device=None, mesh=None):
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        self.multihost = mesh is not None and mesh.world > 1
        self._n_shards = mesh_num_shards(mesh)
        self.ledger = ledger
        self.obs = get_obs(obs)
        if spec is None:
            spec = spec_from_legacy(
                float(budget_per_window), tenant_budgets=tenant_budgets,
                tenant_mode=tenant_mode, n_regions=n_regions)
        self.spec = spec
        self._cs = cs = spec.compile()
        self.budget = cs.total_budget
        self.tenant_budgets = (None if cs.tenants is None else np.asarray(
            cs.tenants.budgets, np.float32))
        self.n_regions = cs.r_n
        self.server = server
        self.chains = server.chains
        self.reward_params = reward_params
        self.reward_cfg = reward_cfg
        self.dual_cfg = dual_cfg or DualDescentConfig()
        self.guard = bool(guard)
        if bucketing not in ("linear", "pow2"):
            raise ValueError(f"bucketing must be 'linear' or 'pow2', "
                             f"got {bucketing!r}")
        self.bucketing = bucketing
        q = math.lcm(int(pad_quantum), self._n_shards)
        if cs.t_n is not None:
            q = math.lcm(q, cs.t_n)
        self.pad_quantum = q
        if server.compact is None:
            raise ValueError("the pipeline needs the compact (k3) layout")
        chains = self.chains
        self._prefix_plan = device_prefix_plan(
            chain_prefix_plan(chains.chain_idx[:, :, 0]), dev)
        self._sh = torch.as_tensor(chains.scale_multihot, device=dev)
        self._costs = torch.as_tensor(chains.costs, dtype=torch.float32,
                                      device=dev)
        self._cheap = int(chains.cheapest())
        j_n = chains.n_chains
        if cs.regions is not None:  # each region's cheapest option
            self._cheap_k = (torch.arange(cs.r_n, device=dev) * j_n
                             + self._cheap)
        c = server.compact
        self._g_of = torch.as_tensor(c.group_of_chain, device=dev)
        self._n3_of = torch.as_tensor(c.n3_of_chain, device=dev)
        self._expose = int(c.expose)
        self._cap = int(c.cap)
        # a streaming universe carries the layout only: every window
        # brings its chunk's tables
        self._stream_only = bool(getattr(server, "stream_only", False))
        self._tables = None if self._stream_only else server.tables
        self.graphs = bool(graphs)
        self._capture_stream = side_stream(dev)
        self._programs: dict = {}  # (b, padded) -> program
        # the nearline price(s): one device buffer, overwritten in place
        self.lam = torch.full((cs.n_prices,) if cs.n_prices else (),
                              float(lam_init), dtype=torch.float32,
                              device=dev)
        self.stats: list[WindowResult] = []

    @classmethod
    def from_spec(cls, server, reward_params: dict,
                  reward_cfg: RewardModelConfig, spec: ConstraintSpec, *,
                  guard: bool = True, lam_init: float = 0.0,
                  **kw) -> "ServingPipeline":
        """Build the pipeline from a declarative ConstraintSpec."""
        return cls(server, reward_params, reward_cfg,
                   spec.compile().total_budget, spec=spec, guard=guard,
                   lam_init=lam_init, **kw)

    def _bucket(self, n: int) -> int:
        """Pad target: the next multiple of ``pad_quantum`` (linear) or
        the next power-of-two multiple of it (pow2)."""
        q = self.pad_quantum
        b = max(q, ((n + q - 1) // q) * q)
        if self.bucketing == "pow2":
            b = q * (1 << max(0, (b + q - 1) // q - 1).bit_length())
        return b

    def window_bucket(self, n: int) -> int:
        """Padded size of an n-request window (tenant windows bucket
        per block; see ``window_layout``)."""
        t_n = self._cs.t_n
        if t_n is None:
            return self._bucket(n)
        if n % t_n:
            raise ValueError(f"window size {n} not divisible by "
                             f"{t_n} tenants")
        return self._bucket(n // t_n) * t_n

    def compile_count(self) -> int:
        """Window-program builds (CUDA graph captures on the card, first
        eager runs elsewhere) across every bucket so far: two per bucket,
        the main pass and the dual loop (three with a mesh: the scoring
        too).  Steady-state traffic on warm buckets holds it still."""
        return sum(p.builds() for p in self._programs.values())

    # -- the window programs -------------------------------------------------

    def _rewards(self, ctx):
        """(b, J) predicted rewards of the window's padded contexts."""
        return denormalize_rewards(self.reward_params, reward_matrix_grouped(
            self.reward_params, self.reward_cfg, ctx, self._sh,
            self._prefix_plan))

    def _execute(self, w, dec):
        """Revenue of this process's rows ``dec``: one truncation launch
        a local shard, at b / S rows (one at b rows without a mesh)."""
        d = dec.long()
        per = d.shape[0] // mesh_local_shards(self.mesh)
        return _cat([_revenue_compact(w.p, w.ck, self._g_of[d[at:at + per]],
                                      w.rows[at:at + per],
                                      self._n3_of[d[at:at + per]],
                                      expose=self._expose)
                     for at in range(0, d.shape[0], per)]
                    ) * w.valid[w.lo:w.hi]

    @torch.no_grad()
    def _score(self, w) -> dict:
        """The mesh's scoring: this process's rows, one local shard at a
        time at b / S rows (a shard's own copy of its contexts), so each
        shard is scored alike on any process."""
        per = w.ctx.shape[0] // mesh_local_shards(self.mesh)
        return {"rewards": _cat(
            [self._rewards(w.ctx[at:at + per].clone())
             for at in range(0, w.ctx.shape[0], per)])}

    @torch.no_grad()
    def _main(self, w, padded: bool) -> dict:
        """Response path: score -> decide -> guard -> execute (with a
        mesh the rewards come scored and gathered)."""
        rewards = self._rewards(w.ctx) if self.mesh is None else w.rewards
        mask = w.valid if padded else None
        n_sh = self._n_shards
        mode = self._cs.mode
        if mode == "geotenants":
            out = self._main_geotenants(w, rewards, mask)
        elif mode == "geo":
            out = self._main_geo(w, rewards, mask)
        else:
            costs = self._costs * w.scale  # cost units (FLOPs or gCO2e)
            if mode == "tenants" and self._cs.tenant_priced:
                dec = allocate(rewards, costs[:, None], w.lam,
                               self._cs.tenant_member(w.k_of))
            else:
                dec = allocate(rewards, costs, w.lam)
            if not self.guard:
                out = self._unguarded(dec, costs, w)
            elif mode == "tenants":
                dec, dg, t_spend = downgrade_guard(
                    dec, costs, w.budget, self._cheap, mask, k_of=w.k_of,
                    n_shards=n_sh)
                out = {"dec": dec, "dg": dg, "spend": torch.sum(t_spend),
                       "t_spend": t_spend}
            else:
                dec, dg, spend = downgrade_guard(dec, costs, w.budget,
                                                 self._cheap, mask,
                                                 n_shards=n_sh)
                out = {"dec": dec, "dg": dg, "spend": spend}
        dec = out["dec"]
        if self.mesh is None:
            out["rewards"] = rewards
        out["flops"] = shard_sum(self._costs[dec.long()] * w.valid, n_sh)
        if self.multihost:  # this process reports its own rows
            for name in ("dec", "regions"):
                if name in out:
                    out[name] = out[name][w.lo:w.hi]
        out["rev"] = self._execute(w, out["dec"])
        return out

    @staticmethod
    def _no_downgrades(dec):
        """The guard's downgrade count where no guard runs."""
        return torch.zeros((), dtype=torch.int32, device=dec.device)

    def _unguarded(self, dec, costs, w) -> dict:
        """The Eq. 10 decisions as served without a guard: nothing
        downgraded, the spend the decided costs over the valid rows."""
        return {"dec": dec, "dg": self._no_downgrades(dec),
                "spend": shard_sum(costs[dec.long()] * w.valid,
                                   self._n_shards)}

    def _region_setup(self, w, rewards):
        """Region-major option costs (m = r*J + j) and the eps_green
        tie-break: about 1e-6 of the reward-per-cost scale, it orders
        the regions at a zero price (a slack window routes green) and is
        dwarfed by any meaningful price."""
        costs = self._costs
        opt_costs = (w.scale[:, None] * costs[None, :]).reshape(-1)
        r_max = torch.max(torch.abs(rewards))
        eps_green = 1e-6 * r_max / (torch.mean(opt_costs) + 1e-30)
        return opt_costs, eps_green

    def _flow_split(self, flops_mass, share):
        """Deterministic proportional rounding of a tied window: walk the
        (masked) FLOPs mass in arrival order and hand region r the
        ``share[r]`` fraction of it (an interval assignment on the
        cumulative mass, exact up to one request per region)."""
        edges = torch.cumsum(share, dim=0)  # (R,) right edges in (0, 1]
        prefix, total = shard_prefix(flops_mass, self._n_shards)
        pos = (prefix - 0.5 * flops_mass) / torch.clamp(total, min=1e-30)
        return torch.sum((pos[:, None] > edges[None, :-1]).to(torch.int64),
                         dim=1)

    def _main_geo(self, w, rewards, mask) -> dict:
        cs, costs, lam, scales = self._cs, self._costs, w.lam, w.scale
        j_n, r_n = costs.shape[0], cs.r_n
        opt_costs, eps_green = self._region_setup(w, rewards)
        if cs.split == "flow":
            # per-flop priced cost per region; the eps_green floor routes
            # slack (lam = 0) windows green
            u = (lam + eps_green) * scales  # (R,)
            r0 = torch.argmin(u)
            sel = r0.view(1)  # a gather, not a host read of the index
            price_best = (lam.gather(0, sel) * scales.gather(0, sel)
                          ) * costs  # (J,)
            dec = torch.argmax(rewards - price_best[None, :], dim=1)
            f = costs[dec] * w.valid
            tied = u <= torch.min(u) * (1.0 + cs.tie_tol)
            cap = torch.where(tied, w.budget / torch.clamp(scales,
                                                           min=1e-30), 0.0)
            total_cap = torch.sum(cap)
            share = cap / (total_cap + 1e-30)
            # zero remaining capacity (share all zero): the priced argmin
            region = torch.where(total_cap > 0, self._flow_split(f, share),
                                 r0)
            dec_m = region * j_n + dec
        else:
            # the joint argmax over (chain, region) factors: each
            # (request, chain) takes its cheapest-priced region, then the
            # chains compete by Eq. 10 (first index on ties)
            unit = scales[:, None] * costs[None, :]  # (R, J)
            price_r = lam[:, None] * unit
            price_irj = price_r[None].expand(rewards.shape[0], r_n, j_n)
            r_star = torch.argmin(price_irj + eps_green * unit[None], dim=1)
            price_best = torch.gather(price_irj, 1, r_star[:, None, :])[:, 0]
            dec = torch.argmax(rewards - price_best, dim=1)
            dec_m = torch.gather(r_star, 1, dec[:, None])[:, 0] * j_n + dec
        if not self.guard:
            return {**self._unguarded(dec_m, opt_costs, w),
                    "dec": dec_m % j_n, "regions": dec_m // j_n}
        dec_m, dg, r_spend = downgrade_guard(
            dec_m, opt_costs, w.budget, self._cheap_k, mask,
            k_of=dec_m.long() // j_n, n_shards=self._n_shards)
        return {"dec": dec_m % j_n, "dg": dg, "spend": torch.sum(r_spend),
                "regions": dec_m // j_n, "r_spend": r_spend}

    def _main_geotenants(self, w, rewards, mask) -> dict:
        cs, costs, lam, scales = self._cs, self._costs, w.lam, w.scale
        j_n, t_n, r_n = costs.shape[0], cs.t_n, cs.r_n
        n_sh = self._n_shards
        opt_costs, eps_green = self._region_setup(w, rewards)
        if cs.tenant_priced:
            lam_r = lam[t_n:]
            lam_ti = lam[:t_n][w.k_of]  # (b,)
        else:  # shared tenants: region prices only, tenant budgets
            lam_r = lam  # enforced by the guard's tenant walk
            lam_ti = torch.zeros(rewards.shape[0], device=rewards.device)
        # per-flop priced cost of serving request i in region r
        q_ir = (lam_ti[:, None] + lam_r[None, :]) * scales[None, :]
        u_ir = q_ir + eps_green * scales[None, :]  # green floor
        r0 = torch.argmin(u_ir, dim=1)  # (b,)
        # the per-flop price factors out of the chain argmax, so chains
        # compete at the chosen region's price (Eq. 10)
        p_i = torch.gather(q_ir, 1, r0[:, None])[:, 0]
        dec = torch.argmax(rewards - p_i[:, None] * costs[None, :], dim=1)
        f = costs[dec] * w.valid
        if cs.split == "flow":
            u_min = torch.gather(u_ir, 1, r0[:, None])[:, 0]
            tied_ir = u_ir <= u_min[:, None] * (1.0 + cs.tie_tol)
            is_tied = torch.sum(tied_ir.to(torch.int32), dim=1) > 1
            # region capacity left after the untied requests
            untied = f * (~is_tied).to(torch.float32)
            fixed = torch.stack([shard_sum(untied * (r0 == r), n_sh)
                                 for r in range(r_n)])
            # shares only cover regions inside some tied request's band
            any_tied = torch.any(tied_ir & is_tied[:, None], dim=0)
            cap = torch.clamp(w.budget[t_n:] / torch.clamp(scales, min=1e-30)
                              - fixed, min=0.0) * any_tied.to(torch.float32)
            total_cap = torch.sum(cap)
            share = cap / (total_cap + 1e-30)
            r_flow = self._flow_split(f * is_tied.to(torch.float32), share)
            # a request never leaves its own tie band, and exhausted
            # capacity falls back to the priced argmin
            ok = torch.gather(tied_ir, 1, r_flow[:, None])[:, 0]
            region = torch.where(is_tied & ok & (total_cap > 0), r_flow, r0)
        else:
            region = r0
        dec_m = region * j_n + dec
        if self.guard:
            # the tenant walk downgrades to the globally cheapest priced
            # option, then the region walk re-caps within each region
            dec_m, dg, _ = downgrade_guard_chain(
                dec_m, opt_costs,
                [(w.budget[:t_n], torch.argmin(opt_costs), w.k_of),
                 (w.budget[t_n:], self._cheap_k, lambda d: d.long() // j_n)],
                mask, n_shards=n_sh)
        else:
            dg = self._no_downgrades(dec_m)
        region = dec_m // j_n
        # per-(tenant, region) spends of the final decisions, one masked
        # (b,) sum a cell
        cd = opt_costs[dec_m.long()] * w.valid
        in_t = [w.k_of == t for t in range(t_n)]
        in_r = [region == r for r in range(r_n)]
        tr_spend = torch.stack([torch.stack([shard_sum(cd * (a & b), n_sh)
                                             for b in in_r]) for a in in_t])
        return {"dec": dec_m % j_n, "dg": dg, "spend": torch.sum(tr_spend),
                "regions": region, "t_spend": torch.sum(tr_spend, dim=1),
                "r_spend": torch.sum(tr_spend, dim=0), "tr_spend": tr_spend}

    @torch.no_grad()
    def _dual(self, w, padded: bool) -> dict:
        """Nearline price update on the window's rewards against the
        dual budget and scale (this window's, or the next window's when
        the caller forecasts).  The (M, K) dual cost map and (I, K)
        membership come from the compiled spec."""
        cs, cfg = self._cs, self.dual_cfg
        mask = w.valid if padded else None
        rewards, budget, member = w.rewards, w.d_budget, None
        j_n = self._costs.shape[0]
        if cs.regions is not None:
            opt_costs = (w.d_scale[:, None] * self._costs[None, :]
                         ).reshape(-1)
            rewards = rewards.repeat(1, cs.r_n)
            if cs.mode == "geotenants":
                costs = cs.dual_cost_map(opt_costs, j_n)
                member = cs.dual_member(w.k_of, rewards.shape[0])
                if not cs.tenant_priced:
                    budget = budget[cs.t_n:]
            else:
                costs = cs.region_cost_map(opt_costs, j_n)
        else:
            costs = self._costs * w.d_scale
            if cs.tenant_priced:
                costs = costs[:, None]
                member = cs.tenant_member(w.k_of)
            elif cs.mode == "tenants":  # one price on the total budget
                budget = torch.sum(budget)
        lam, _ = dual_descent(
            rewards, costs, budget, w.lam, mask=mask, member=member,
            max_iters=cfg.max_iters, step_size=cfg.step_size,
            step_decay=cfg.step_decay, n_shards=self._n_shards)
        return {"lam": lam}

    # -- public API ----------------------------------------------------------

    def _named_vector(self, value, names: tuple, what: str):
        """A named per-axis dict -> the positional vector (a number for
        the single global axis); anything else passes through."""
        if not isinstance(value, dict):
            return value
        missing = [k for k in names if k not in value]
        extra = [k for k in value if k not in names]
        if missing or extra:
            raise ValueError(
                f"named {what} keys must be exactly {list(names)} "
                f"(missing {missing}, unknown {extra})")
        vec = np.asarray([float(value[k]) for k in names], np.float32)
        return float(vec[0]) if names == ("global",) else vec

    def _window_budgets(self, budget, cost_scale):
        """This window's (budget vector or None, reported budget, mean
        cost scale, budget knob, scale knob) for the spec's mode."""
        cs = self._cs
        mode = cs.mode
        if mode in ("geo", "geotenants"):
            if budget is None or cost_scale is None:
                raise ValueError(
                    f"{mode} mode serves against per-region budgets: pass "
                    f"a ({cs.budget_len()},) budget (tenants first) and an "
                    f"({cs.r_n},) cost_scale every window")
            bud_vec = np.asarray(budget, np.float32).reshape(-1)
            sc_vec = np.asarray(cost_scale, np.float32).reshape(-1)
            if len(bud_vec) != cs.budget_len() or len(sc_vec) != cs.r_n:
                raise ValueError(
                    f"{mode} budget/cost_scale must have {cs.budget_len()} "
                    f"and {cs.r_n} entries, got {len(bud_vec)} and "
                    f"{len(sc_vec)}")
            if mode == "geotenants":  # the tighter of the two totals
                t_n = cs.t_n
                bud = float(min(bud_vec[:t_n].sum(), bud_vec[t_n:].sum()))
            else:
                bud = float(bud_vec.sum())
            return bud_vec, bud, float(sc_vec.mean()), bud_vec, sc_vec
        sc = 1.0 if cost_scale is None else float(cost_scale)
        if mode == "tenants":
            if budget is None:
                bud_vec = self.tenant_budgets
            else:
                bud_vec = np.asarray(budget, np.float32).reshape(-1)
                if len(bud_vec) != cs.t_n:
                    raise ValueError(f"tenant budget override must have "
                                     f"{cs.t_n} entries")
            return bud_vec, float(bud_vec.sum()), sc, bud_vec, sc
        bud = self.budget if budget is None else float(budget)
        return None, bud, sc, bud, sc

    def serve_window(self, ctx: np.ndarray, rows: np.ndarray, *,
                     lam=None, update_lam: bool = True, budget=None,
                     cost_scale=None, dual_budget=None,
                     dual_cost_scale=None, tables: dict | None = None,
                     ready=None, shard=None) -> WindowResult:
        """Serve one window: ctx (n, d_context) raw contexts; rows (n,)
        user rows of a materialized server, or with ``tables`` (a
        ``WindowChunk``'s (G, n, cap) tables, required over a streaming
        universe) local indices into them.  Decisions use ``lam``
        (default: the nearline price lambda_{t-1}); the pass then
        publishes lambda_t unless ``update_lam=False``.

        ``budget`` overrides this window's budget: a number in the plain
        mode, (T,) with tenants, (R,) with regions and (T + R,) with
        both (tenant budgets first; required with regions, together
        with an (R,) ``cost_scale``).  ``cost_scale`` re-denominates the
        costs as ``costs * cost_scale`` (carbon pricing passes kappa *
        CI(t) with a gCO2e budget).  Both also take the named form, a
        dict keyed by the compiled spec's ``budget_names`` /
        ``scale_names``.  ``dual_budget``/``dual_cost_scale`` aim the
        nearline update at another (budget, scale) - the next window's,
        for the CI-forecast warm start (default: this window's).
        ``ready`` is the chunk's event (``WindowChunk.ready``) when its
        tables were made on another stream.

        ``shard`` (a ``distributed.multihost.HostWindowSlice``, carried by
        a ``MultihostSource`` chunk) serves a multi-process window:
        ``ctx``, ``rows`` and ``tables`` are this process's padded rows of
        the window, ``shard`` its global request count and bucket."""
        dev = self.device
        cs = self._cs
        if shard is not None and not self.multihost:
            raise ValueError("serve_window(shard=...) needs a pipeline "
                             "built over the multi-process mesh "
                             "(multihost=True)")
        if self.multihost and shard is None:
            raise ValueError("a multihost pipeline serves host slices: "
                             "pass shard= (use a MultihostSource)")
        n = len(rows) if shard is None else int(shard.n)
        if self._stream_only != (tables is not None) and n:
            raise ValueError(
                "a streaming universe's windows carry their chunk tables "
                "(serve_window(..., tables=chunk.tables)); a materialized "
                "server's windows index its own")
        bn, sn = cs.budget_names, cs.scale_names
        budget = self._named_vector(budget, bn, "budget")
        dual_budget = self._named_vector(dual_budget, bn, "dual_budget")
        cost_scale = self._named_vector(cost_scale, sn, "cost_scale")
        dual_cost_scale = self._named_vector(dual_cost_scale, sn,
                                             "dual_cost_scale")
        bud_vec, bud, sc, b_knob, s_knob = self._window_budgets(
            budget, cost_scale)
        k_budget = None if bud_vec is None else np.array(bud_vec)
        if n == 0:  # zero-arrival window: nothing to serve or learn from
            lam_rec = self.lam.clone()
            zero = torch.zeros((), device=dev)
            t_n, r_n = cs.t_n, cs.r_n
            res = WindowResult(
                n_valid=0, budget=bud, lam_before=lam_rec,
                lam_after=lam_rec,
                decisions=torch.zeros(0, dtype=torch.int32, device=dev),
                revenue=torch.zeros(0, device=dev), spend=zero,
                downgraded=torch.zeros((), dtype=torch.int32, device=dev),
                valid=np.zeros(0, np.float32), flops=zero, cost_scale=sc,
                tenant_spend=(None if t_n is None
                              else torch.zeros(t_n, device=dev)),
                regions=(None if r_n is None else torch.zeros(
                    0, dtype=torch.int64, device=dev)),
                region_spend=(None if r_n is None
                              else torch.zeros(r_n, device=dev)),
                tr_spend=(torch.zeros((t_n, r_n), device=dev)
                          if cs.mode == "geotenants" else None),
                k_budget=k_budget)
            self.stats.append(res)
            if self.ledger is not None:
                self.ledger.record_result(res)
            return res
        chunked = self._stream_only
        if shard is not None and not chunked:
            raise ValueError("multihost serving streams chunk tables; "
                             "materialized (U, J) serving is "
                             "single-process only")
        run_tables = None
        table_h2d = 0
        if chunked:
            if not isinstance(tables["p"], torch.Tensor):  # host tables
                table_h2d = int(tables["p"].nbytes + tables["ck"].nbytes)
            p = torch.as_tensor(tables["p"])
            ck = torch.as_tensor(tables["ck"])
            if p.shape[1] != len(rows):
                raise ValueError(f"chunk tables carry {p.shape[1]} rows "
                                 f"for a {len(rows)}-row window")
            consume((p, ck), ready)
            run_tables = (p, ck)
        b = self.window_bucket(n)
        # every process derives the whole window's layout from (n, b)
        perm, valid, k_of = window_layout(n, b, cs.t_n)
        key = (b, b != n)
        c0 = self.compile_count()
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _WindowProgram(self, b, b != n,
                                                        chunked)
        if shard is not None:  # this process's rows, already laid out
            if (int(shard.b) != b or len(rows) != prog.hi - prog.lo
                    or not np.array_equal(np.asarray(shard.valid),
                                          valid[prog.lo:prog.hi])):
                raise ValueError(
                    f"host slice of {len(rows)} rows (bucket {shard.b}) "
                    f"does not match rows [{prog.lo}, {prog.hi}) of the "
                    f"{n}-request window's {b}-row layout")
            ctx_p = np.asarray(ctx, np.float32)
            rows_p = np.asarray(rows, np.int64)
        else:
            real = valid > 0
            ctx_p = np.zeros((b, np.shape(ctx)[1]), np.float32)
            ctx_p[real] = np.asarray(ctx, np.float32)[perm[real]]
            if chunked:  # rows index the padded chunk
                rows_p = perm
            else:
                rows_p = np.zeros(b, np.int64)
                rows_p[real] = np.asarray(rows, np.int64)[perm[real]]
        knobs = [b_knob, s_knob,
                 b_knob if dual_budget is None else dual_budget,
                 s_knob if dual_cost_scale is None else dual_cost_scale]
        with self.obs.span("h2d", n=n, b=b):
            h2d = table_h2d + prog.load(ctx_p, rows_p, valid, k_of, knobs,
                                        run_tables,
                                        self.lam if lam is None else lam)
        lam_before = prog.lam.clone()
        if self.mesh is not None:
            with self.obs.span("score", n=n, b=b), \
                    record_function("window/score"):
                scored = prog.score()["rewards"]
            with self.obs.span("gather", n=n, b=b):
                self._gather_rewards(prog, scored)
        with self.obs.span("dispatch", n=n, b=b), \
                record_function("window/main"):
            out = prog.main()
        if self.mesh is None:
            prog.rewards.copy_(out["rewards"])
        with self.obs.span("dual_update", n=n, b=b), \
                record_function("window/dual"):
            lam_new = prog.dual()["lam"]
        if update_lam:
            self.lam.copy_(lam_new)  # in place: the price buffer is reused
            lam_after = self.lam.clone()
        else:
            lam_after = lam_new.clone()

        def own(name):
            return out[name].clone() if name in out else None

        res = WindowResult(
            n_valid=n, budget=bud, lam_before=lam_before,
            lam_after=lam_after, decisions=own("dec"), revenue=own("rev"),
            spend=own("spend"), downgraded=own("dg"),
            valid=valid[prog.lo:prog.hi], flops=own("flops"),
            cost_scale=sc, tenant_spend=own("t_spend"),
            regions=own("regions"), region_spend=own("r_spend"),
            tr_spend=own("tr_spend"), k_budget=k_budget,
            compiles=self.compile_count() - c0, bucket=key,
            h2d_bytes=int(h2d),
            rows_global=(np.arange(prog.lo, prog.hi) if self.multihost
                         else None))
        self.stats.append(res)
        if self.ledger is not None:  # parks the record: no device read
            self.ledger.record_result(res)
        return res

    def _gather_rewards(self, prog, scored) -> None:
        """This process's scored rows -> the window's (b, J) rewards in
        ``prog.rewards``, through the program's pinned host buffers over
        P > 1 processes (``distributed.sharding.gather_shards``: its copy
        to the host waits for the scoring)."""
        gather_shards(scored, self.mesh, host=prog.host_rows,
                      every=prog.host_all, out=prog.rewards)

    def spend_trace(self) -> np.ndarray:
        return np.array([float(torch.sum(r.spend)) for r in self.stats])
