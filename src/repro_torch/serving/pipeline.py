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
reuses a handful of shapes.  Each bucket ``(b, padded)`` gets one window
program (the port's jitted pass per bucket): static input buffers, the
response path captured as the ``window/main`` CUDA graph and the dual
loop as ``window/dual``, replayed on every later window of the bucket
(``graphs.Program``).  ``WindowResult.compiles`` counts the captures a
window caused - zero on a warm bucket.  ``graphs=False`` runs the same
programs eagerly through the same buffers: the reference the captured
windows are held to, and what the CPU runs.  Only the plain
``[GlobalAxis]`` spec is supported.
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
                                           device_prefix_plan,
                                           reward_matrix_grouped)
from repro_torch.device import resolve_device
from repro_torch.graphs import Program, consume, record_event, side_stream
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
    """One served window; tensors stay on the device until read, and are
    the window's own (copies of the program's static outputs)."""

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
    compiles: int = 0  # program captures this window caused (0 = warm)
    bucket: tuple | None = None  # the (b, padded) program key
    h2d_bytes: int = 0
    prep_ms: float = 0.0  # host chunk production (set by run_stream)
    stall_ms: float = 0.0  # wait for a prefetched chunk (run_stream)

    @property
    def decisions_np(self) -> np.ndarray:
        return self.decisions.cpu().numpy()[self.valid > 0]

    @property
    def revenue_np(self) -> np.ndarray:
        return self.revenue.cpu().numpy()[self.valid > 0]


class _WindowProgram:
    """One padding bucket's window program: static inputs (contexts,
    rows, validity, the padded tables, the entry price, the rewards the
    dual reads), two pinned staging slots used in turn, and the
    ``window/main`` and ``window/dual`` programs on one graph pool."""

    def __init__(self, pipe: "ServingPipeline", b: int, padded: bool):
        dev = pipe.device
        g_n, d = len(pipe.server.compact.p_sorted), pipe.reward_cfg.d_context
        self.ctx = torch.zeros((b, d), device=dev)
        self.rows = torch.zeros(b, dtype=torch.int64, device=dev)
        self.valid = torch.zeros(b, device=dev)
        self.p = torch.full((g_n, b, pipe._cap), pipe._cap,
                            dtype=torch.int32, device=dev)
        self.ck = torch.zeros((g_n, b, pipe._cap), device=dev)
        self.lam = torch.zeros((), device=dev)
        self.rewards = torch.zeros((b, pipe.chains.n_chains), device=dev)
        pin = dev.type == "cuda"
        self._slots = [[torch.zeros((b, d), pin_memory=pin),
                        torch.zeros(b, dtype=torch.int64, pin_memory=pin),
                        torch.zeros(b, pin_memory=pin), None]
                       for _ in range(2)]
        self._turn = 0
        capture = pipe.graphs and dev.type == "cuda"
        kw = dict(capture=capture, stream=pipe._capture_stream,
                  pool=torch.cuda.graph_pool_handle() if capture else None)
        mask = self.valid if padded else None

        def main():
            rewards, dec, rev, spend, dg = pipe._main(
                self.p, self.ck, self.ctx, self.rows, self.valid, self.lam,
                padded)
            flops = torch.sum(pipe._costs[dec.long()] * self.valid)
            return {"rewards": rewards, "dec": dec, "rev": rev,
                    "spend": spend, "dg": dg, "flops": flops}

        def dual():
            cfg = pipe.dual_cfg
            lam, _ = dual_descent(
                self.rewards, pipe._costs, pipe.budget, self.lam, mask=mask,
                max_iters=cfg.max_iters, step_size=cfg.step_size,
                step_decay=cfg.step_decay)
            return {"lam": lam}

        self.main = Program(main, **kw)
        self.dual = Program(dual, **kw)

    def builds(self) -> int:
        return self.main.builds + self.dual.builds

    def load(self, ctx: np.ndarray, perm: np.ndarray, valid: np.ndarray,
             p, ck, lam) -> int:
        """Fill the static inputs for one window on the current stream:
        host arrays by pinned ``non_blocking`` copies, the tables by
        device copies (padding rows: the sentinel and no clicks), the
        price by a device copy or a fill.  Returns the bytes copied from
        the host."""
        n = len(ctx)
        slot = self._slots[self._turn]
        self._turn ^= 1
        if slot[3] is not None:
            slot[3].synchronize()  # this slot's last copies are done
        host_ctx = slot[0].numpy()
        host_ctx[:n] = ctx
        host_ctx[n:] = 0.0
        slot[1].numpy()[:] = perm
        slot[2].numpy()[:] = valid
        for dst, src in zip((self.ctx, self.rows, self.valid), slot[:3]):
            dst.copy_(src, non_blocking=True)
        slot[3] = record_event(torch.cuda.current_stream()
                               if self.ctx.is_cuda else None)
        self.p[:, :n].copy_(p)
        self.p[:, n:].fill_(self.p.shape[2])
        self.ck[:, :n].copy_(ck)
        self.ck[:, n:].zero_()
        if isinstance(lam, torch.Tensor):
            self.lam.copy_(lam)
        else:
            self.lam.fill_(float(lam))
        return sum(t.numel() * t.element_size() for t in slot[:3])


class ServingPipeline:
    """Per-window serving pass over a streaming universe.

    ``server`` is a ``StreamUniverse`` (chain set + compact layout);
    every ``serve_window`` brings a chunk's tables.  ``reward_params``
    is the reward model's parameter tree on ``device`` (with
    ``label_norm`` when trained on ratio labels).  ``device`` defaults
    to the card and raises without one.  ``graphs`` (default) captures
    each bucket's window program as CUDA graphs on the card;
    ``graphs=False`` runs the same programs eagerly (the reference).
    """

    def __init__(self, server, reward_params: dict,
                 reward_cfg: RewardModelConfig, budget_per_window: float,
                 *, dual_cfg: DualDescentConfig | None = None,
                 pad_quantum: int = 32, bucketing: str = "linear",
                 spec: ConstraintSpec | None = None, graphs: bool = True,
                 device=None):
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
        self._prefix_plan = device_prefix_plan(
            chain_prefix_plan(chains.chain_idx[:, :, 0]), dev)
        self._sh = torch.as_tensor(chains.scale_multihot, device=dev)
        self._costs = torch.as_tensor(chains.costs, dtype=torch.float32,
                                      device=dev)
        self._cheap = int(chains.cheapest())
        c = server.compact
        self._g_of = torch.as_tensor(c.group_of_chain, device=dev)
        self._n3_of = torch.as_tensor(c.n3_of_chain, device=dev)
        self._expose = int(c.expose)
        self._cap = int(c.cap)
        self.graphs = bool(graphs)
        self._capture_stream = side_stream(dev)
        self._programs: dict = {}  # (b, padded) -> _WindowProgram
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

    def compile_count(self) -> int:
        """Window-program builds (CUDA graph captures on the card, first
        eager runs elsewhere) across every bucket so far: two per bucket,
        the main pass and the dual loop.  Steady-state traffic on warm
        buckets holds it still."""
        return sum(p.builds() for p in self._programs.values())

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
                     tables: dict, lam=None, update_lam: bool = True,
                     ready=None) -> WindowResult:
        """Serve one window: ctx (n, d_context) raw contexts, rows (n,)
        LOCAL indices into the chunk ``tables``.  Decisions use ``lam``
        (default: the nearline price lambda_{t-1}); the pass then
        publishes lambda_t unless ``update_lam=False``.  ``ready`` is the
        chunk's event (``WindowChunk.ready``) when its tables were made
        on another stream: the window waits for it on the device."""
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
        p = torch.as_tensor(tables["p"])
        ck = torch.as_tensor(tables["ck"])
        if p.shape[1] != n:
            raise ValueError(f"chunk tables carry {p.shape[1]} rows for "
                             f"a {n}-request window")
        b = self._bucket(n)
        key = (b, b != n)
        c0 = self.compile_count()
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _WindowProgram(self, b, b != n)
        perm, valid = window_layout(n, b)
        consume((p, ck), ready)
        h2d = prog.load(np.asarray(ctx, np.float32), perm, valid, p, ck,
                        self.lam if lam is None else lam)
        lam_before = prog.lam.clone()
        with record_function("window/main"):
            out = prog.main()
        prog.rewards.copy_(out["rewards"])
        with record_function("window/dual"):
            lam_new = prog.dual()["lam"]
        if update_lam:
            self.lam.copy_(lam_new)  # in place: the price buffer is reused
            lam_after = self.lam.clone()
        else:
            lam_after = lam_new.clone()
        res = WindowResult(
            n_valid=n, budget=self.budget, lam_before=lam_before,
            lam_after=lam_after, decisions=out["dec"].clone(),
            revenue=out["rev"].clone(), spend=out["spend"].clone(),
            downgraded=out["dg"].clone(), valid=valid,
            flops=out["flops"].clone(), compiles=self.compile_count() - c0,
            bucket=key, h2d_bytes=int(h2d))
        self.stats.append(res)
        return res
