"""GreenFlow streaming serving on the port.

    python -m repro_torch.launch.serve --source generated \\
        [--device cuda|cpu] [--windows N] [--requests N] [--users N] \\
        [--prefetch N] [--scenario NAME] [--tenants T] \\
        [--tenant-mode shared|priced|independent] [--tenant-spread X]

streams a ``GeneratedSource`` day: every window samples arrivals from a
hash-generated user universe, scores DSSM, YDNN, DIN and DIEN over the
whole corpus on the device, compacts the scores into CompactPlan tables
and serves the window (reward scoring -> Eq. 10 -> guard -> cascade ->
nearline dual update).  Scoring and each padding bucket's window pass
replay CUDA graphs captured on first use; a producer thread makes the
next ``--prefetch`` windows' chunks while the card serves (0: the
sequential reference path, bitwise the same windows).  It prints one
line per window: n, spend/budget, lambda (one per tenant when priced),
downgraded, revenue, host ms, the ms the serving thread waited for its
chunk, the graph captures the window caused (0 once its bucket is warm)
and its bucket.

``--scenario tenants`` serves ``--tenants`` equal blocks a window under
per-tenant budgets that sum to the window budget, spread so the loosest
tenant has ``--tenant-spread`` times the tightest one's (1: equal):
``shared`` - one price on the total, the guard capping each tenant;
``priced`` - a price per tenant in the same window pass;
``independent`` - one pipeline per tenant.  ``carbon``, ``georegions``
and ``geotenants`` need the port of ``repro.carbon`` (ROADMAP A9) for
their grid-intensity traces and exit until then; their window programs
are served through ``ServingPipeline.from_spec``.

The full-width stack is the paper's: a 4000-item corpus with 100-long
histories, the ``paper_stage_specs`` chains with expose 20, the stage
models at their dataclass widths (DIN and DIEN at the published DIN
config: embed 18, seq_len 100, attention 80-40, MLP 200-80) with
vocabularies sized to the world, and the reward model at
d_feature 64 / d_hidden 64 / d_state 32.  Weights are random, drawn
from ``--seed`` by the port's own inits; ``--small`` shrinks the world
and the widths for a quick run on the CPU (``--device cpu``).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.cascade.engine import CascadeModels
from repro_torch.core.action_chain import (ActionChainSet, ModelInstance,
                                           StageSpec,
                                           generate_action_chains,
                                           paper_stage_specs)
from repro_torch.core.reward_model import (RewardModelConfig,
                                           reward_model_init)
from repro_torch.data.request_source import GeneratedSource
from repro_torch.data.synthetic import StreamingWorld, WorldConfig
from repro_torch.device import resolve_device
from repro_torch.models.recsys import dien, din, dssm, ydnn
from repro_torch.serving.pipeline import ServingPipeline
from repro_torch.serving.stream import (SCENARIOS, StreamStats,
                                        TrafficScenario, run_stream,
                                        window_table)

FULL_ITEMS, FULL_HIST, FULL_EXPOSE = 4000, 100, 20


def world_config(users: int, *, small: bool = False,
                 seed: int = 0) -> WorldConfig:
    if small:
        return WorldConfig(n_users=users, n_items=400, hist_len=20,
                           seed=seed)
    return WorldConfig(n_users=users, n_items=FULL_ITEMS,
                       hist_len=FULL_HIST, seed=seed)


def small_stage_specs(n_items: int, expose: int) -> tuple:
    """The paper's chain space scaled to a small corpus: n2 in 20-50%
    and n3 in [expose, 20%] of it, 4 scales each."""
    n2 = tuple(sorted({int(x) for x in
                       np.linspace(0.2 * n_items, 0.5 * n_items, 4)}))
    n3 = tuple(sorted({max(expose, int(x)) for x in
                       np.linspace(expose, 0.2 * n_items, 4)}))
    return (
        StageSpec("recall", (ModelInstance("DSSM", 13e3),), (n_items,), 4),
        StageSpec("prerank", (ModelInstance("YDNN", 123e3),), n2, 4),
        StageSpec("rank", (ModelInstance("DIN", 7020e3),
                           ModelInstance("DIEN", 7098e3)), n3, 4),
    )


def build_chains(wcfg: WorldConfig, expose: int, *,
                 small: bool = False) -> ActionChainSet:
    if small:
        return generate_action_chains(small_stage_specs(wcfg.n_items,
                                                        expose))
    return generate_action_chains(paper_stage_specs())


def build_models(wcfg: WorldConfig, gen: torch.Generator, device, *,
                 small: bool = False) -> CascadeModels:
    """Stage models with vocabularies sized to the world."""
    n_uf = wcfg.n_user_fields
    voc = dict(item_vocab=wcfg.n_items, user_vocab=n_uf
               * wcfg.user_field_vocab)
    rank = dict(voc, cat_vocab=wcfg.n_cats, n_user_fields=n_uf,
                seq_len=wcfg.hist_len)
    if small:
        dssm_cfg = dssm.DSSMConfig(**voc, n_user_fields=n_uf, embed_dim=4,
                                   hidden=(16, 8), d_out=4)
        ydnn_cfg = ydnn.YDNNConfig(**voc, n_user_fields=n_uf,
                                   hist_len=wcfg.hist_len, embed_dim=8,
                                   hidden=(24, 12), d_out=8)
        rank.update(embed_dim=4, attn_hidden=(16, 8), mlp_hidden=(16, 8))
    else:
        dssm_cfg = dssm.DSSMConfig(**voc, n_user_fields=n_uf)
        ydnn_cfg = ydnn.YDNNConfig(**voc, n_user_fields=n_uf,
                                   hist_len=wcfg.hist_len)
    din_cfg = din.DINConfig(**rank)
    dien_cfg = dien.DIENConfig(**rank)
    return CascadeModels(
        dssm.init(gen, dssm_cfg, device), dssm_cfg,
        ydnn.init(gen, ydnn_cfg, device), ydnn_cfg,
        din.init(gen, din_cfg, device), din_cfg,
        dien.init(gen, dien_cfg, device), dien_cfg)


def reward_config(chains: ActionChainSet, d_context: int, *,
                  small: bool = False) -> RewardModelConfig:
    """``configs/greenflow_cascade.full_config`` widths (2 models, 4
    scale groups) with the world's context width."""
    widths = (dict(d_feature=16, d_hidden=16, d_state=8) if small
              else dict(d_feature=64, d_hidden=64, d_state=32))
    return RewardModelConfig(
        n_stages=chains.n_stages, max_models=2, n_scale_groups=4,
        d_context=d_context, **widths)


NEEDS_CARBON = ("carbon", "georegions", "geotenants")


def tenant_budgets(budget: float, n: int, spread: float) -> np.ndarray:
    """``n`` tenant budgets summing to ``budget``, rising linearly from
    the tightest to ``spread`` times it."""
    w = np.linspace(1.0, spread, n)
    return (budget * w / w.sum()).astype(np.float32)


@dataclass
class ServeStack:
    source: GeneratedSource
    pipelines: list  # one, or one a tenant (--tenant-mode independent)
    sizes: list
    budget: float
    c_max: float
    device: torch.device

    @property
    def pipeline(self) -> ServingPipeline:
        if len(self.pipelines) != 1:
            raise ValueError("independent tenants serve one pipeline each")
        return self.pipelines[0]


def build_stack(*, users: int = 100_000, requests: int = 512,
                windows: int = 6, scenario: str = "constant",
                budget_frac: float = 0.6, seed: int = 0,
                expose: int | None = None, chunk: int = 512,
                item_block: int = 256, small: bool = False,
                tenants: int = 4, tenant_mode: str = "shared",
                tenant_spread: float = 1.0, device=None) -> ServeStack:
    """World, chains, random-weight stage and reward models, the
    ``GeneratedSource`` and the pipeline(s), all on ``device``; with
    ``scenario="tenants"``, ``tenants`` blocks a window under
    ``tenant_mode``."""
    if scenario in NEEDS_CARBON:
        raise SystemExit(
            f"--scenario {scenario} needs the grid-intensity traces of "
            f"repro.carbon, not ported yet (ROADMAP A9); its window "
            f"program runs through ServingPipeline.from_spec")
    if tenant_mode not in ("shared", "priced", "independent"):
        raise ValueError(f"unknown tenant mode {tenant_mode!r}")
    dev = resolve_device(device)
    expose = (8 if small else FULL_EXPOSE) if expose is None else expose
    wcfg = world_config(users, small=small, seed=seed)
    world = StreamingWorld.build(wcfg)
    chains = build_chains(wcfg, expose, small=small)
    gen = torch.Generator().manual_seed(seed)
    models = build_models(wcfg, gen, dev, small=small)
    rcfg = reward_config(chains, world.d_context, small=small)
    rparams = reward_model_init(gen, rcfg, dev)
    source = GeneratedSource(world, models, chains, expose=expose,
                             seed=seed, chunk=chunk, item_block=item_block,
                             device=dev)
    budget = float(budget_frac * chains.costs.max() * requests)
    n_tenants = tenants if scenario == "tenants" else 1
    sizes = TrafficScenario(scenario, windows, requests,
                            n_tenants=n_tenants).window_sizes()
    if n_tenants == 1:
        pipes = [ServingPipeline(source.universe, rparams, rcfg, budget,
                                 device=dev)]
    elif tenant_mode == "independent":
        pipes = [ServingPipeline(source.universe, rparams, rcfg, float(b),
                                 device=dev)
                 for b in tenant_budgets(budget, n_tenants, tenant_spread)]
    else:
        pipes = [ServingPipeline(
            source.universe, rparams, rcfg, budget,
            tenant_budgets=tenant_budgets(budget, n_tenants, tenant_spread),
            tenant_mode=tenant_mode, device=dev)]
    return ServeStack(source, pipes, sizes, budget,
                      float(chains.costs.max()), dev)


def serve(stack: ServeStack, *, sync: bool = True, prefetch: int = 2,
          pipeline: ServingPipeline | None = None) -> StreamStats:
    """Run the stack's windows through its pipeline (or ``pipeline``,
    one of the independent tenants', which serves its share of every
    window) with ``prefetch`` chunks made ahead on a producer thread (0:
    sequentially); with ``sync`` the per-window times include the
    device work."""
    do_sync = None
    if sync and stack.device.type == "cuda":
        do_sync = torch.cuda.synchronize
    sizes = stack.sizes
    if pipeline is None:
        pipeline = stack.pipeline
    else:
        sizes = [n // len(stack.pipelines) for n in sizes]
    with torch.no_grad():
        return run_stream(pipeline, sizes, stack.source, prefetch=prefetch,
                          sync=do_sync)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="GreenFlow streaming serving on PyTorch/CUDA")
    ap.add_argument("--source", default="generated", choices=("generated",),
                    help="request source (only the hash-generated "
                         "stream is ported)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card the run "
                         "fails unless --device cpu is given")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--requests", type=int, default=512,
                    help="requests per normal window")
    ap.add_argument("--users", type=int, default=100_000,
                    help="size of the streamed user universe")
    ap.add_argument("--scenario", default="constant",
                    choices=tuple(SCENARIOS))
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--tenant-mode", default="shared",
                    choices=("shared", "priced", "independent"))
    ap.add_argument("--tenant-spread", type=float, default=1.0,
                    help="--scenario tenants: budget ratio of the loosest "
                         "to the tightest tenant")
    ap.add_argument("--budget-frac", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="small world and narrow models (CPU-sized)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="window-prep prefetch queue depth (0 = the "
                         "sequential double-buffered reference path)")
    args = ap.parse_args(argv)
    stack = build_stack(users=args.users, requests=args.requests,
                        windows=args.windows, scenario=args.scenario,
                        budget_frac=args.budget_frac, seed=args.seed,
                        small=args.small, tenants=args.tenants,
                        tenant_mode=args.tenant_mode,
                        tenant_spread=args.tenant_spread,
                        device=args.device)
    print(f"[serve] device {stack.device}, {len(stack.sizes)} windows, "
          f"U={args.users:,}, budget {stack.budget:.4e} FLOPs/window")
    if len(stack.pipelines) == 1:
        runs = [serve(stack, prefetch=args.prefetch)]
    else:
        runs = [serve(stack, prefetch=args.prefetch, pipeline=p)
                for p in stack.pipelines]
    c_min = float(stack.source.chains.costs.min())
    for k, st in enumerate(runs):
        if len(runs) > 1:
            print(f"[serve] tenant {k} (independent pipeline)")
        for line in window_table(st):
            print(line)
        print(f"[serve] {len(st.sizes)} windows in {st.wall_s:.2f}s, worst "
              f"overshoot vs cap: {st.overshoot(c_min) * 100:.3f}%, "
              f"revenue {st.total_revenue:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
