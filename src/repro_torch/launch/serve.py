"""GreenFlow streaming serving on the port.

    python -m repro_torch.launch.serve [--small] [--device cuda|cpu] \\
        [--source table|generated|memmap] [--replay-dir DIR] [--legacy] \\
        [--windows N] [--requests N] [--users N] [--prefetch N] \\
        [--scenario NAME] [--tenants T] \\
        [--tenant-mode shared|priced|independent] [--tenant-spread X] \\
        [--metrics-out PATH] [--trace-out PATH] [--profile-dir DIR] \
        [--shards S] [--processes P --process-id I --coordinator HOST:PORT]

builds the trained stack of the JAX package's CLI
(``experiments.build_serving_stack(serve_config(small=...))``: the world,
the four cascade models and the reward model trained on the device, the
experiment cached under ``results/torch/cache/``) and serves
``--windows`` windows (default 12 of ``--requests`` 96, the ``spike``
scenario) through the window pass (reward scoring -> Eq. 10 -> guard ->
cascade -> nearline dual update).  Each padding bucket's window pass
replays CUDA graphs captured on first use; a producer thread makes the
next ``--prefetch`` windows while the card serves (0: the sequential
reference path, bitwise the same windows).  It prints one line per
window: n, spend/budget, lambda (one per tenant when priced),
downgraded, revenue, host ms, the ms the serving thread waited for its
window, the graph captures the window caused (0 once its bucket is
warm) and its bucket.

Request sources (``--seed`` seeds each):

``--source table``      (default) arrivals drawn from the evaluation
                        users of the trained experiment, served off the
                        materialized ``CascadeServer``'s tables;
``--source generated``  a ``GeneratedSource`` stream over a
                        ``--users``-user ``StreamingWorld`` of the
                        experiment's world, scored by the trained models;
``--source memmap``     a ``TableReplaySource`` of the evaluation users
                        loaded memmapped from ``--replay-dir`` (default
                        ``results/torch/replay_universe``), saved there
                        first when the directory has no ``meta.json``.

``--legacy`` serves the seed's host loop instead (table source only):
the full reward matrix scored on the device, ``BudgetController`` (on
the carbon day ``CarbonBudgetController`` with the ledger) deciding and
guarding on the host, then ``CascadeServer.serve``.

``--scenario tenants`` serves ``--tenants`` equal blocks a window under
per-tenant budgets that sum to the window budget, spread so the loosest
tenant has ``--tenant-spread`` times the tightest one's (1: equal):
``shared`` - one price on the total, the guard capping each tenant;
``priced`` - a price per tenant in the same window pass;
``independent`` - one pipeline per tenant.

The carbon days make the run one 24 h day (``--windows`` windows of
86400 / windows s each) over the diurnal traffic curve:

``--scenario carbon``      per-window gCO2e budgets and chain costs
                           flops_j * kappa * CI(t) from the grid trace
                           (``--ci-trace diurnal|duck|constant`` or
                           ``--ci-csv FILE``, ``--ci-mean``,
                           ``--ci-phase-h``), ``--carbon-pricing
                           carbon|flops``, metered by a ``CarbonLedger``;
``--scenario georegions``  the two-region router, region CI days
                           ``--geo-offset-h`` apart, (R,) gram budgets
                           and prices, ``--geo-split flow|argmax``, a
                           ledger a region;
``--scenario geotenants``  ``--tenants`` gram budgets spread
                           ``--tenant-spread`` x (default 4) and region
                           caps of ``--region-cap-frac`` of their total,
                           priced together in one window pass.

``--ci-forecast`` aims each nearline update at the next window's
intensity; ``--embodied-g-per-device-h`` and ``--devices`` set the
ledger's embodied carbon.  Each day prints its window table, the
ledger's report (realized and all-max-chain kWh and gCO2e, embodied
carbon, daily savings, FLOPs by stage and model) and writes the
ledger's CSV to ``--carbon-report`` (default ``results/torch/
carbon_report{,_geo,_geotenants}.csv``).

Request mesh: ``--shards S`` serves every window over S request shards
in this process (the pad quantum becomes a multiple of S; each shard's
rows scored at b / S rows, every cross-shard sum folded in shard order,
``serving.pipeline``).  ``--processes P`` serves over P processes, one a
card, every process running the same command with its own
``--process-id`` and the ``--coordinator`` address of process 0 (or the
``GREENFLOW_COORDINATOR``, ``GREENFLOW_NUM_PROCESSES`` and
``GREENFLOW_PROCESS_ID`` environment variables)::

    python -m repro_torch.launch.serve --source generated \
        --processes 2 --process-id 0 --coordinator 127.0.0.1:29511 &
    python -m repro_torch.launch.serve --source generated \
        --processes 2 --process-id 1 --coordinator 127.0.0.1:29511

The processes join one gloo group (``distributed.multihost``); the
request mesh has one shard a process, each process generates its own
rows of every window (arrivals are pure (seed, t) functions, so no
request crosses between processes), the window's rewards are gathered
through the host once a window, and every process computes the same
prices, spends and decisions, bit for bit, as ``--shards P`` in one
process.  It needs a streaming ``--source`` (generated or memmap: every
process needs the same universe) and no ``--shards`` or ``--legacy``;
``--metrics-out`` and ``--trace-out`` get the host label as a suffix
(``PATH.host0``, ...).  Elastic resizing is checkpoint and replay
(``distributed.multihost.checkpoint_stream``).

Telemetry (``repro_torch.obs``): ``--metrics-out PATH`` writes a
Prometheus-text snapshot (+ ``PATH.json`` and the per-window JSONL
flight log ``PATH.windows.jsonl``), ``--trace-out PATH`` the host span
trace as Chrome trace-event JSON, ``--obs-interval N`` prints a live
line every N windows, ``--profile-dir DIR`` runs under
``torch.profiler`` (CPU and CUDA activities) with the host spans as
``record_function`` ranges and writes ``DIR/trace.json``.  Telemetry
changes no decision or price.

``build_stack`` is the library's random-weight stack at the paper's
widths: a 4000-item corpus with 100-long histories, the
``paper_stage_specs`` chains with expose 20, the stage models at their
dataclass widths (DIN and DIEN at the published DIN config: embed 18,
seq_len 100, attention 80-40, MLP 200-80) with vocabularies sized to the
world, and the reward model at d_feature 64 / d_hidden 64 / d_state 32,
weights drawn from a seed by the port's own inits, over a
``GeneratedSource``.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import experiments
from repro_torch.carbon.controller import (CarbonBudget,
                                           CarbonBudgetController,
                                           grams_per_flop)
from repro_torch.carbon.intensity import (IntensityTrace, constant_trace,
                                          diurnal_trace, load_ci_csv,
                                          solar_duck_trace,
                                          two_region_traces)
from repro_torch.carbon.ledger import (DAY_S,
                                       DEFAULT_EMBODIED_G_PER_DEVICE_H,
                                       CarbonLedger, geo_report_csv)
from repro_torch.cascade.engine import CascadeModels
from repro_torch.core.action_chain import (ActionChainSet, ModelInstance,
                                           StageSpec,
                                           generate_action_chains,
                                           paper_stage_specs)
from repro_torch.core.budget import BudgetController
from repro_torch.core.pfec import pfec_report
from repro_torch.core.primal_dual import DualDescentConfig
from repro_torch.core.reward_model import (RewardModelConfig,
                                           denormalize_rewards,
                                           reward_matrix,
                                           reward_model_init)
from repro_torch.data.request_source import (GeneratedSource,
                                             TableReplaySource)
from repro_torch.data.synthetic import StreamingWorld, WorldConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import multihost as mh
from repro_torch.launch.mesh import make_request_mesh
from repro_torch.models.recsys import dien, din, dssm, ydnn
from repro_torch.obs import Obs, WindowEventLog
from repro_torch.serving.pipeline import ServingPipeline
from repro_torch.serving.spec import (ConstraintSpec, GlobalAxis,
                                      RegionAxis, TenantAxis)
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


CARBON_DAYS = ("carbon", "georegions", "geotenants")
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "results", "torch")


def tenant_budgets(budget: float, n: int, spread: float) -> np.ndarray:
    """``n`` tenant budgets summing to ``budget``, rising linearly from
    the tightest to ``spread`` times it."""
    w = np.linspace(1.0, spread, n)
    return (budget * w / w.sum()).astype(np.float32)


def scenario_sizes(scenario: str, windows: int, requests: int, *,
                   tenants: int = 4, spike: float = 3.0) -> list[int]:
    """Per-window request counts: ``tenants`` equal blocks a window in
    the ``tenants`` and ``geotenants`` scenarios."""
    n_tenants = tenants if scenario in ("tenants", "geotenants") else 1
    return TrafficScenario(scenario, windows, requests, spike_mult=spike,
                           n_tenants=n_tenants).window_sizes()


@dataclass
class ServeStack:
    """What a serving run needs: ``source`` (a ``RequestSource``, or a
    ``sample_window(t, n) -> (ctx, rows)`` callable over a materialized
    server), ``server`` (what pipelines are built over: the source's
    ``universe``, or the materialized ``CascadeServer``), the chains, the
    pipeline(s), the window sizes and budget, the reward model, and for a
    trained stack its experiment ``exp``."""

    source: object
    pipelines: list  # one, or one a tenant; none for the carbon days
    sizes: list
    budget: float
    c_max: float
    device: torch.device
    reward_params: dict
    reward_cfg: RewardModelConfig
    server: object = None  # default: source.universe
    exp: object = None
    mesh: object = None  # the request mesh every pipeline is built over

    def __post_init__(self):
        if self.server is None:
            self.server = self.source.universe

    @property
    def chains(self) -> ActionChainSet:
        return self.server.chains

    @property
    def pipeline(self) -> ServingPipeline:
        if len(self.pipelines) != 1:
            raise ValueError(
                f"the stack holds {len(self.pipelines)} pipelines "
                f"(independent tenants serve one each; the carbon days "
                f"build their own)")
        return self.pipelines[0]


def routed(source, pipeline):
    """``source`` as ``pipeline`` serves it: through a ``MultihostSource``
    (this process's rows of every window) when the pipeline spans
    processes, as it is otherwise."""
    if pipeline.multihost and not isinstance(source, mh.MultihostSource):
        return mh.MultihostSource(source, pipeline)
    return source


def _pipelines(server, params: dict, rcfg: RewardModelConfig,
               budget: float, scenario: str, *, tenants: int,
               tenant_mode: str, tenant_spread: float, obs,
               device, mesh=None) -> list:
    """The scenario's pipeline(s) over ``server``, on ``mesh``: none for
    the carbon days (they build their own), one a tenant when tenants are
    independent, else one."""
    if tenant_mode not in ("shared", "priced", "independent"):
        raise ValueError(f"unknown tenant mode {tenant_mode!r}")
    kw = dict(obs=obs, device=device, mesh=mesh)
    if scenario in CARBON_DAYS:
        return []
    if scenario != "tenants":
        return [ServingPipeline(server, params, rcfg, budget, **kw)]
    shares = tenant_budgets(budget, tenants, tenant_spread)
    if tenant_mode == "independent":
        return [ServingPipeline(server, params, rcfg, float(b), **kw)
                for b in shares]
    return [ServingPipeline(server, params, rcfg, budget,
                            tenant_budgets=shares, tenant_mode=tenant_mode,
                            **kw)]


def build_stack(*, users: int = 100_000, requests: int = 512,
                windows: int = 6, scenario: str = "constant",
                budget_frac: float = 0.6, seed: int = 0,
                expose: int | None = None, chunk: int = 512,
                item_block: int = 256, small: bool = False,
                tenants: int = 4, tenant_mode: str = "shared",
                tenant_spread: float = 1.0, spike: float = 3.0, obs=None,
                device=None, mesh=None) -> ServeStack:
    """World, chains, random-weight stage and reward models, the
    ``GeneratedSource`` and the pipeline(s), all on ``device``; with
    ``scenario="tenants"``, ``tenants`` blocks a window under
    ``tenant_mode``.  The carbon days (``CARBON_DAYS``) build their
    pipelines themselves (``carbon_day``, ``region_day``), so their stack
    holds none.  ``mesh`` is the request mesh of every pipeline."""
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
                             obs=obs, device=dev)
    budget = float(budget_frac * chains.costs.max() * requests)
    sizes = scenario_sizes(scenario, windows, requests, tenants=tenants,
                           spike=spike)
    pipes = _pipelines(source.universe, rparams, rcfg, budget, scenario,
                       tenants=tenants, tenant_mode=tenant_mode,
                       tenant_spread=tenant_spread, obs=obs, device=dev,
                       mesh=mesh)
    return ServeStack(source, pipes, sizes, budget,
                      float(chains.costs.max()), dev, rparams, rcfg,
                      mesh=mesh)


def table_sampler(exp, *, seed: int = 0):
    """The JAX CLI's ``--source table`` windows: ``sample_window(t, n)``
    draws n rows of the evaluation users from one
    ``np.random.default_rng(seed)`` (window after window) and returns
    their contexts and rows."""
    rng = np.random.default_rng(seed)
    n_eval = exp.ctx_eval.shape[0]

    def sample_window(t: int, n: int):
        rows = rng.integers(0, n_eval, n)
        return exp.ctx_eval[rows], rows

    return sample_window


REPLAY_DIR = "replay_universe"  # --source memmap's default, under RESULTS


def trained_stack(exp, server, params: dict, rcfg: RewardModelConfig, *,
                  source: str = "table", users: int = 100_000,
                  replay_dir: str | None = None, requests: int = 96,
                  windows: int = 12, scenario: str = "spike",
                  budget_frac: float = 0.6, seed: int = 0, tenants: int = 4,
                  tenant_mode: str = "shared", tenant_spread: float = 1.0,
                  spike: float = 3.0, obs=None, mesh=None) -> ServeStack:
    """The CLI's stack over ``experiments.build_serving_stack``'s trained
    experiment, materialized server and reward model, on the server's
    device, with the request ``source`` of ``--source`` (see the module
    docstring) and every pipeline on the request ``mesh``."""
    dev = server.device
    chains = exp.chains
    if source == "table":
        src = table_sampler(exp, seed=seed)
        print(f"[serve] source: the {len(exp.ctx_eval):,} evaluation users "
              f"of the trained experiment (materialized tables)")
    elif source == "generated":
        wcfg = replace(exp.cfg.world, n_users=users)
        src = GeneratedSource(StreamingWorld.build(wcfg), exp.models, chains,
                              expose=exp.cfg.expose, seed=seed, obs=obs,
                              device=dev)
        server = src.universe
        print(f"[serve] source: generated stream over U={users:,} "
              f"hash-materialized users (no per-user tables held)")
    elif source == "memmap":
        path = replay_dir or os.path.join(RESULTS, REPLAY_DIR)
        if not os.path.exists(os.path.join(path, "meta.json")):
            print(f"[serve] saving replay universe -> {path}")
            TableReplaySource.from_server(server, exp.ctx_eval).save(path)
        src = TableReplaySource.load(path, chains, seed=seed, device=dev)
        server = src.universe
        print(f"[serve] source: memmapped replay of U={src.n_users:,} "
              f"users from {path}")
    else:
        raise ValueError(f"unknown source {source!r}")
    budget = float(budget_frac * chains.costs.max() * requests)
    sizes = scenario_sizes(scenario, windows, requests, tenants=tenants,
                           spike=spike)
    pipes = _pipelines(server, params, rcfg, budget, scenario,
                       tenants=tenants, tenant_mode=tenant_mode,
                       tenant_spread=tenant_spread, obs=obs, device=dev,
                       mesh=mesh)
    return ServeStack(src, pipes, sizes, budget, float(chains.costs.max()),
                      dev, params, rcfg, server=server, exp=exp, mesh=mesh)


def _sync(stack: ServeStack):
    """``torch.cuda.synchronize`` after every window on the card, so the
    per-window times include the device work."""
    return torch.cuda.synchronize if stack.device.type == "cuda" else None


def serve(stack: ServeStack, *, sync: bool = True, prefetch: int = 2,
          pipeline: ServingPipeline | None = None, obs=None) -> StreamStats:
    """Run the stack's windows through its pipeline (or ``pipeline``,
    one of the independent tenants', which serves its share of every
    window) with ``prefetch`` chunks made ahead on a producer thread (0:
    sequentially); with ``sync`` the per-window times include the
    device work."""
    sizes = stack.sizes
    if pipeline is None:
        pipeline = stack.pipeline
    else:
        sizes = [n // len(stack.pipelines) for n in sizes]
    with torch.no_grad():
        return run_stream(pipeline, sizes, routed(stack.source, pipeline),
                          prefetch=prefetch, obs=obs,
                          sync=_sync(stack) if sync else None)


# -- the carbon days ----------------------------------------------------------


@dataclass
class CarbonDay:
    """One served carbon, georegions or geotenants day: the stream, its
    pipeline, the ledgers (one, or one a region) and each window's
    budget, cost scale and grid intensity (a (W,) array a ledger)."""

    stats: StreamStats
    pipeline: ServingPipeline
    ledgers: dict
    budgets: np.ndarray
    scales: np.ndarray | None
    ci: dict
    report: str

    @property
    def total_revenue(self) -> float:
        return self.stats.total_revenue

    @property
    def total_flops(self) -> float:
        return float(sum(float(r.flops) for r in self.stats.windows))


def build_ci_trace(args) -> IntensityTrace:
    """The grid-intensity trace of ``--ci-csv`` or ``--ci-trace`` at
    ``--ci-mean``."""
    if args.ci_csv:
        return load_ci_csv(args.ci_csv)
    if args.ci_trace == "diurnal":
        return diurnal_trace(mean=args.ci_mean)
    if args.ci_trace == "duck":
        return solar_duck_trace(mean=args.ci_mean)
    return constant_trace(args.ci_mean)


def _report_path(args, name: str) -> str:
    return os.path.abspath(args.carbon_report
                           or os.path.join(RESULTS, name))


def _day_sizes(args) -> list[int]:
    return scenario_sizes(args.scenario, args.windows, args.requests,
                          tenants=args.tenants, spike=args.spike)


def tenant_spread(args) -> float:
    """``--tenant-spread``; by default 4 for ``geotenants`` (the JAX
    CLI's) and 1 for ``tenants``."""
    if args.tenant_spread is not None:
        return args.tenant_spread
    return 4.0 if args.scenario == "geotenants" else 1.0


def _embodied(args) -> float:
    return (DEFAULT_EMBODIED_G_PER_DEVICE_H
            if args.embodied_g_per_device_h is None
            else args.embodied_g_per_device_h)


def ledger_block(rep: dict, devices: int) -> list[str]:
    """The ledger's report as the JAX CLI prints it after a carbon day:
    realized and all-max-chain energy and carbon, embodied carbon, the
    daily savings, FLOPs by stage and by model."""
    lines = [
        f"    realized      {rep['kwh']:.4e} kWh  {rep['gco2e']:.4e} gCO2e",
        f"    all-max base  {rep['baseline_kwh']:.4e} kWh  "
        f"{rep['baseline_gco2e']:.4e} gCO2e",
        f"    embodied      {rep['embodied_gco2e']:.4e} gCO2e "
        f"({devices} device(s) amortized)  total "
        f"{rep['total_gco2e']:.4e} gCO2e",
        f"    daily savings {rep['daily_saved_kwh']:.4e} kWh/day  "
        f"{rep['daily_saved_tco2e']:.4e} tCO2e/day (vs all-max-chain)"]
    lines += [f"    stage {s:10s} {v:.4e} FLOPs"
              for s, v in rep["stage_flops"].items()]
    lines += [f"    model {m:10s} {v:.4e} FLOPs"
              for m, v in rep["model_flops"].items()]
    return lines


def _carbon_budget(stack: ServeStack, args, sizes: list, obs=None):
    """The carbon day's intensity trace, ``CarbonBudget`` (the stack's
    FLOPs budget at the trace's mean intensity) and ``CarbonLedger``."""
    trace = build_ci_trace(args)
    window_s = DAY_S / len(sizes)
    cb = CarbonBudget.from_flops(stack.budget, trace, window_s=window_s,
                                 phase_s=args.ci_phase_h * 3600.0)
    ledger = CarbonLedger(stack.chains, trace, window_s=window_s,
                          phase_s=cb.phase_s,
                          embodied_g_per_device_h=_embodied(args),
                          n_devices=args.devices, obs=obs)
    print(f"[serve] carbon day: {len(sizes)} windows x "
          f"{window_s / 3600.0:.2f} h, CI '{trace.name}' mean "
          f"{trace.mean():.0f} g/kWh, budget {cb.grams_per_window:.3e} "
          f"g/window ({args.carbon_pricing} pricing)")
    return cb, ledger


def _write_ledger(ledger: CarbonLedger, args) -> str:
    path = _report_path(args, "carbon_report.csv")
    ledger.to_csv(path)
    print(f"\n[serve] carbon ledger -> {path}")
    for line in ledger_block(ledger.report(), args.devices):
        print(line)
    return path


def carbon_day(stack: ServeStack, args, *, source=None,
               obs=None) -> CarbonDay:
    """The carbon-budgeted day: diurnal traffic (``--windows`` spanning
    24 h) priced against the grid-intensity trace, per-window gCO2e
    budgets and kappa * CI(t) cost scales through ``run_stream``
    (``--carbon-pricing carbon``) or the effective-FLOPs-budget
    reduction (``flops``); ``--ci-forecast`` aims each nearline update at
    the next window's intensity.  A ``CarbonLedger`` attached to the
    pipeline meters every window lazily and writes ``--carbon-report``.
    ``source`` (a ``RequestSource`` or a ``sample_window`` callable)
    defaults to the stack's."""
    src = stack.source if source is None else source
    sizes = _day_sizes(args)
    cb, ledger = _carbon_budget(stack, args, sizes, obs)
    sched = cb.schedule(len(sizes))
    pipe = ServingPipeline(stack.server, stack.reward_params,
                           stack.reward_cfg, cb.flops_ref, ledger=ledger,
                           obs=obs, device=stack.device, mesh=stack.mesh)
    if args.carbon_pricing == "carbon":
        budgets, scales = sched["grams"], sched["scale"]
    else:
        budgets, scales = sched["flops_budget"], None
    with torch.no_grad():
        st = run_stream(pipe, sizes, routed(src, pipe), budget_trace=budgets,
                        scale_trace=scales, forecast=args.ci_forecast,
                        prefetch=args.prefetch, obs=obs,
                        sync=_sync(stack))
    print(f"{'win':>4} {'n':>5} {'ci_g/kwh':>9} {'spend/budget':>13} "
          f"{'lam':>12} {'downgraded':>10} {'revenue':>9} "
          f"{'dispatch_ms':>11} {'cap':>3}")
    for t, r in enumerate(st.windows):
        print(f"{t:>4} {r.n_valid:>5} {sched['ci'][t]:>9.1f} "
              f"{float(r.spend) / r.budget:>13.3f} "
              f"{float(r.lam_after):>12.3e} {int(r.downgraded):>10d} "
              f"{float(np.sum(r.revenue_np)):>9.1f} "
              f"{st.dispatch_ms[t]:>11.2f} {r.compiles:>3d}")
    print(f"[serve] {len(sizes)} windows in {st.wall_s:.2f}s "
          f"({len(sizes) / st.wall_s:.1f} win/s)")
    path = _write_ledger(ledger, args)
    return CarbonDay(st, pipe, {ledger.name: ledger}, np.asarray(budgets),
                     None if scales is None else np.asarray(scales),
                     {ledger.name: sched["ci"]}, path)


def _print_geo_ledgers(ledgers: dict, path: str, devices: int) -> None:
    print(f"\n[serve] per-region carbon ledger -> {path}")
    for name, led in ledgers.items():
        rep = led.report()
        print(f"    {name}: {rep['gco2e']:.4e} g operational + "
              f"{rep['embodied_gco2e']:.4e} g embodied = "
              f"{rep['total_gco2e']:.4e} gCO2e ({rep['n_requests']} "
              f"requests)")
        for line in ledger_block(rep, devices):
            print("  " + line)


def _region_rows(st: StreamStats, names: list, ci_w: dict) -> list[str]:
    """The georegions window table: the split, each region's CI and
    spend/budget."""
    header = " ".join(f"{'ci_' + r[-1]:>6} {'spd/bud_' + r[-1]:>9}"
                      for r in names)
    lines = [f"{'win':>4} {'n':>5} {'split':>12} {header} {'revenue':>9} "
             f"{'dispatch_ms':>11} {'cap':>3}"]
    for t, r in enumerate(st.windows):
        split = np.bincount(r.regions_np, minlength=len(names)).tolist()
        spends = r.region_spend.cpu().numpy()
        cols = " ".join(f"{ci_w[name][t]:>6.0f} "
                        f"{spends[k] / r.k_budget[k]:>9.3f}"
                        for k, name in enumerate(names))
        lines.append(f"{t:>4} {r.n_valid:>5} {str(split):>12} {cols} "
                     f"{float(np.sum(r.revenue_np)):>9.1f} "
                     f"{st.dispatch_ms[t]:>11.2f} {r.compiles:>3d}")
    return lines


def _tenant_region_rows(st: StreamStats, names: list, tenant_g: np.ndarray,
                        region_g: np.ndarray) -> list[str]:
    """The geotenants window table: the split, each tenant's and each
    region's spend/budget."""
    t_n, r_n = len(tenant_g), len(region_g)
    t_hdr = " ".join(f"{'t' + str(k) + ' s/b':>8}" for k in range(t_n))
    r_hdr = " ".join(f"{'r_' + r[-1] + ' s/b':>8}" for r in names)
    lines = [f"{'win':>4} {'n':>5} {'split':>12} {t_hdr} {r_hdr} "
             f"{'revenue':>9} {'dispatch_ms':>11} {'cap':>3}"]
    for t, r in enumerate(st.windows):
        split = np.bincount(r.regions_np, minlength=r_n).tolist()
        tr = r.tr_spend.cpu().numpy()
        t_cols = " ".join(f"{tr[k].sum() / tenant_g[k]:>8.3f}"
                          for k in range(t_n))
        r_cols = " ".join(f"{tr[:, k].sum() / region_g[k]:>8.3f}"
                          for k in range(r_n))
        lines.append(f"{t:>4} {r.n_valid:>5} {str(split):>12} {t_cols} "
                     f"{r_cols} {float(np.sum(r.revenue_np)):>9.1f} "
                     f"{st.dispatch_ms[t]:>11.2f} {r.compiles:>3d}")
    return lines


def region_day(stack: ServeStack, args, *, source=None,
               obs=None) -> CarbonDay:
    """The two-region days, region CI days ``--geo-offset-h`` apart and
    kappa * CI_r(t) cost scales, the region split ``--geo-split``, with a
    ledger a region merged into one CSV with a ``region`` column.
    ``--scenario georegions``: (R,) gram budgets through the router
    (``[RegionAxis(2), GlobalAxis(pricing="carbon")]``).  ``--scenario
    geotenants``: ``--tenants`` gram budgets spread ``--tenant-spread`` x
    and per-region gram caps of ``--region-cap-frac`` of their total,
    priced in one window pass (``[TenantAxis, RegionAxis(2),
    GlobalAxis(pricing="carbon")]``; a tenant-t request pays
    (lam_tenant[t] + lam_region[r]) * c_{j,r} when ``--tenant-mode
    priced``).  ``source`` (a ``RequestSource`` or a ``sample_window``
    callable) defaults to the stack's."""
    tenants = args.scenario == "geotenants"
    if tenants and args.tenant_mode == "independent":
        raise SystemExit("--scenario geotenants composes tenants and "
                         "regions in ONE pipeline; --tenant-mode "
                         "independent contradicts that (use shared or "
                         "priced)")
    src = stack.source if source is None else source
    sizes = _day_sizes(args)
    n_w = len(sizes)
    traces = two_region_traces(mean=args.ci_mean,
                               offset_h=args.geo_offset_h)
    names = list(traces)
    r_n = len(names)
    window_s = DAY_S / n_w
    phase_s = args.ci_phase_h * 3600.0
    ci_w = {r: traces[r].resample(n_w, window_s, phase_s=phase_s)
            for r in names}
    scales = np.stack([grams_per_flop(1.0) * ci_w[r] for r in names],
                      axis=1)
    g_total = stack.budget * grams_per_flop(1.0) * args.ci_mean
    regions = RegionAxis(r_n, names=tuple(names), split=args.geo_split)
    if tenants:
        w = np.linspace(1.0, tenant_spread(args), args.tenants)
        tenant_g = (g_total * w / w.sum()).astype(np.float64)
        region_g = np.full(r_n, args.region_cap_frac * g_total)
        budgets = np.tile(np.concatenate([tenant_g, region_g]), (n_w, 1))
        axes = [TenantAxis(tuple(tenant_g),
                           priced=args.tenant_mode == "priced"),
                regions, GlobalAxis(pricing="carbon")]
        report = "carbon_report_geotenants.csv"
        print(f"[serve] geotenants day: {n_w} windows x "
              f"{window_s / 3600.0:.2f} h, {args.tenants} tenants x {r_n} "
              f"regions (offset {args.geo_offset_h:.0f} h), tenant grams "
              + "/".join(f"{g:.2e}" for g in tenant_g)
              + f", region cap {region_g[0]:.2e} g "
              f"({args.region_cap_frac:.0%} of total), split "
              f"{args.geo_split}, tenant-mode {args.tenant_mode}")
    else:
        budgets = np.full((n_w, r_n), g_total / r_n)
        axes = [regions, GlobalAxis(budget=float(stack.budget),
                                    pricing="carbon")]
        report = "carbon_report_geo.csv"
        print(f"[serve] geo day: {n_w} windows x {window_s / 3600.0:.2f} h, "
              f"regions {names} offset {args.geo_offset_h:.0f} h, "
              f"{g_total / r_n:.3e} g/window/region, split "
              f"{args.geo_split}")
    pipe = ServingPipeline.from_spec(
        stack.server, stack.reward_params, stack.reward_cfg,
        ConstraintSpec(axes), obs=obs,
        dual_cfg=DualDescentConfig(max_iters=300, step_decay=0.98),
        device=stack.device, mesh=stack.mesh)
    with torch.no_grad():
        st = run_stream(pipe, sizes, routed(src, pipe), budget_trace=budgets,
                        scale_trace=scales, forecast=args.ci_forecast,
                        prefetch=args.prefetch, obs=obs,
                        sync=_sync(stack))
    rows = (_tenant_region_rows(st, names, tenant_g, region_g) if tenants
            else _region_rows(st, names, ci_w))
    for line in rows:
        print(line)
    print(f"[serve] {n_w} windows in {st.wall_s:.2f}s "
          f"({n_w / st.wall_s:.1f} win/s)")
    if tenants:
        spent = sum((r.tr_spend.cpu().numpy().sum(axis=1)
                     for r in st.windows), np.zeros(len(tenant_g)))
        print("[serve] day totals, per tenant (spend_g / budget_g): "
              + " ".join(f"t{k}={spent[k] / (n_w * g):.3f}"
                         for k, g in enumerate(tenant_g)))
    # one ledger a region, each window's decisions metered in the region
    # that served them, at that region's CI
    ledgers = {
        r: CarbonLedger(stack.chains, traces[r], window_s=window_s,
                        phase_s=phase_s, name=r, obs=obs,
                        embodied_g_per_device_h=_embodied(args),
                        n_devices=args.devices)
        for r in names}
    for t, r in enumerate(st.windows):
        served, dec = r.regions_np, r.decisions_np
        for k, name in enumerate(names):
            ledgers[name].record(dec[served == k], t=t, ci=ci_w[name][t])
    path = _report_path(args, report)
    geo_report_csv(ledgers, path)
    _print_geo_ledgers(ledgers, path, args.devices)
    return CarbonDay(st, pipe, ledgers, budgets, scales, ci_w, path)


DAYS = {"carbon": carbon_day, "georegions": region_day,
        "geotenants": region_day}


# -- the seed's host loops (--legacy) ----------------------------------------


def make_legacy_scorer(exp, rcfg: RewardModelConfig, device=None):
    """The seed's reward scorer, shared by every legacy host loop:
    ``score(params, ctx) -> (n, J)`` de-normalized rewards, the full
    ``reward_matrix`` (every chain scored on its own) on ``device``."""
    dev = resolve_device(device)
    mo = torch.as_tensor(exp.chains.model_onehot, device=dev)
    sh = torch.as_tensor(exp.chains.scale_multihot, device=dev)

    @torch.no_grad()
    def score(params: dict, ctx):
        c = torch.as_tensor(ctx, dtype=torch.float32, device=dev)
        return denormalize_rewards(params,
                                   reward_matrix(params, rcfg, c, mo, sh))

    return score


def make_legacy_window(exp, server, params: dict, rcfg: RewardModelConfig,
                       budget: float):
    """The seed's serving path: the rewards scored on the server's device,
    ``BudgetController`` deciding, guarding and updating the price on the
    host, then ``CascadeServer.serve`` (the ``cascade_truncate`` kernel on
    the card).  Returns (controller, window_fn) with window_fn(ctx, rows)
    -> (decisions, revenue)."""
    score = make_legacy_scorer(exp, rcfg, server.device)
    ctl = BudgetController(exp.chains, budget)

    def window(ctx, rows):
        dec = ctl.step_window(score(params, ctx))
        rev, _ = server.serve(rows, dec)
        return dec, rev

    return ctl, window


def _legacy_loop(exp, server, params: dict, rcfg: RewardModelConfig,
                 sizes: list, budget: float, *, seed: int = 0):
    """The host loop over ``table_sampler``'s windows; prints the JAX
    CLI's legacy table and returns (revenue, FLOPs)."""
    ctl, window = make_legacy_window(exp, server, params, rcfg, budget)
    sample_window = table_sampler(exp, seed=seed)
    total_rev = total_flops = 0.0
    print(f"{'win':>4} {'n':>5} {'spend/budget':>13} {'lam':>12} "
          f"{'downgraded':>10} {'revenue':>9} {'window_ms':>9}")
    for t, n in enumerate(sizes):
        t0 = time.perf_counter()
        dec, rev = window(*sample_window(t, n))
        dt = (time.perf_counter() - t0) * 1e3
        s = ctl.stats[-1]
        total_rev += rev.sum()
        total_flops += s.spend
        print(f"{t:>4} {n:>5} {s.spend / s.budget:>13.3f} {s.lam:>12.3e} "
              f"{s.downgraded:>10d} {rev.sum():>9.1f} {dt:>9.2f}")
    return float(total_rev), float(total_flops)


def _legacy_carbon_loop(exp, server, params: dict, rcfg: RewardModelConfig,
                        sizes: list, cb: CarbonBudget, ledger,
                        sample_window, pricing: str):
    """The carbon day on ``CarbonBudgetController`` (the host loop twin
    of ``carbon_day``), metering each window into ``ledger``; prints the
    JAX CLI's table and returns (revenue, FLOPs)."""
    score = make_legacy_scorer(exp, rcfg, server.device)
    ctl = CarbonBudgetController(exp.chains, cb, ledger=ledger,
                                 pricing=pricing)
    total_rev = total_flops = 0.0
    print(f"{'win':>4} {'n':>5} {'ci_g/kwh':>9} {'spend_g/budget_g':>17} "
          f"{'lam':>12} {'downgraded':>10} {'revenue':>9}")
    for t, n in enumerate(sizes):
        ctx, rows = sample_window(t, n)
        dec = ctl.step_window(score(params, ctx))
        rev, _ = server.serve(rows, dec)
        s = ctl.stats[-1]
        total_rev += rev.sum()
        total_flops += s.flops
        print(f"{t:>4} {n:>5} {s.ci_g_per_kwh:>9.1f} "
              f"{s.spend_g / s.budget_g:>17.3f} {s.lam:>12.3e} "
              f"{s.downgraded:>10d} {rev.sum():>9.1f}")
    return float(total_rev), float(total_flops)


def legacy_carbon_day(stack: ServeStack, args) -> tuple[float, float]:
    """``--scenario carbon --legacy``: the carbon day through
    ``_legacy_carbon_loop`` on the stack's table source, its ledger
    written as ``carbon_day`` writes it."""
    sizes = _day_sizes(args)
    cb, ledger = _carbon_budget(stack, args, sizes)
    out = _legacy_carbon_loop(stack.exp, stack.server, stack.reward_params,
                              stack.reward_cfg, sizes, cb, ledger,
                              stack.source, args.carbon_pricing)
    _write_ledger(ledger, args)
    return out


# -- the command line ---------------------------------------------------------


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="GreenFlow streaming serving on PyTorch/CUDA")
    ap.add_argument("--source", default="table",
                    choices=("table", "generated", "memmap"),
                    help="request source: index the materialized eval "
                         "universe, stream a hash-generated one, or "
                         "replay memmapped tables")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card the run "
                         "fails unless --device cpu is given")
    ap.add_argument("--windows", type=int, default=12)
    ap.add_argument("--requests", type=int, default=96,
                    help="requests per normal window")
    ap.add_argument("--users", type=int, default=100_000,
                    help="--source generated: size of the streamed user "
                         "universe")
    ap.add_argument("--replay-dir", default=None,
                    help="--source memmap: directory of the saved .npy "
                         "universe (default: results/torch/"
                         "replay_universe)")
    ap.add_argument("--legacy", action="store_true",
                    help="run the seed's host loop instead (table source; "
                         "with --scenario carbon the "
                         "CarbonBudgetController loop)")
    ap.add_argument("--scenario", default="spike",
                    choices=tuple(SCENARIOS))
    ap.add_argument("--spike", type=float, default=3.0,
                    help="traffic multiplier on the spike windows")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--tenant-mode", default="shared",
                    choices=("shared", "priced", "independent"))
    ap.add_argument("--tenant-spread", type=float, default=None,
                    help="budget ratio of the loosest to the tightest "
                         "tenant (default 1 for --scenario tenants, 4 "
                         "for geotenants)")
    ap.add_argument("--budget-frac", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the request source")
    ap.add_argument("--small", action="store_true",
                    help="the CI-sized experiment (serve_config(small="
                         "True))")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="window-prep prefetch queue depth (0 = the "
                         "sequential double-buffered reference path)")
    ap.add_argument("--ci-trace", default="diurnal",
                    choices=("diurnal", "duck", "constant"),
                    help="grid-intensity shape for --scenario carbon")
    ap.add_argument("--ci-csv", default=None,
                    help="load the intensity trace from an exported CSV "
                         "(ichnos parse_ci_intervals layouts)")
    ap.add_argument("--ci-mean", type=float, default=450.0,
                    help="mean grid intensity, gCO2e/kWh")
    ap.add_argument("--ci-phase-h", type=float, default=0.0,
                    help="hours the intensity day leads the traffic day")
    ap.add_argument("--carbon-pricing", default="carbon",
                    choices=("carbon", "flops"))
    ap.add_argument("--carbon-report", default=None,
                    help="CSV path for the carbon ledger (default: "
                         "results/torch/carbon_report.csv, "
                         "carbon_report_geo.csv for georegions, "
                         "carbon_report_geotenants.csv for geotenants)")
    ap.add_argument("--ci-forecast", action="store_true",
                    help="aim the nearline dual at the NEXT window's "
                         "known CI (the carbon days)")
    ap.add_argument("--geo-offset-h", type=float, default=8.0,
                    help="hours region b's CI peak trails region a's")
    ap.add_argument("--geo-split", default="flow",
                    choices=("flow", "argmax"),
                    help="region-tie rounding: 'flow' = exact "
                         "proportional flow split of the degenerate "
                         "window, 'argmax' = the knife edge")
    ap.add_argument("--region-cap-frac", type=float, default=0.6,
                    help="geotenants: each region's per-window gram cap "
                         "as a fraction of the total tenant grams")
    ap.add_argument("--embodied-g-per-device-h", type=float, default=None,
                    help="embodied-carbon amortization per device-hour "
                         "(default: the ichnos-style server constant; "
                         "0 disables the ledger line)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices metered for embodied carbon (per "
                         "region in georegions)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a Prometheus-text metrics snapshot here "
                         "at exit (plus a JSON snapshot at PATH.json and "
                         "the per-window JSONL flight log at "
                         "PATH.windows.jsonl)")
    ap.add_argument("--trace-out", default=None,
                    help="write the host span trace as Chrome "
                         "trace-event JSON (open in ui.perfetto.dev; the "
                         "producer and serving threads land on separate "
                         "tracks)")
    ap.add_argument("--obs-interval", type=int, default=0,
                    help=">0: print a compact live telemetry line every "
                         "N windows")
    ap.add_argument("--profile-dir", default=None,
                    help="run under torch.profiler (CPU and CUDA "
                         "activities) and write its Chrome trace here; "
                         "host spans become record_function ranges")
    ap.add_argument("--shards", type=int, default=0,
                    help=">0: serve every window over an N-shard request "
                         "mesh in this process")
    ap.add_argument("--processes", type=int, default=0,
                    help=">1: join a group of N serve processes (one a "
                         "card); the request mesh then spans them and "
                         "each process generates its rows of every "
                         "window (see the module docstring)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in the --processes group "
                         "(default: $GREENFLOW_PROCESS_ID)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the group's coordinator (process "
                         "0's address; default: $GREENFLOW_COORDINATOR)")
    return ap


def _make_obs(args, host: str | None = None):
    """The telemetry bundle the obs flags ask for (None: off), its rows
    and trace labelled ``host`` in a multi-process run."""
    if not (args.metrics_out or args.trace_out or args.obs_interval
            or args.profile_dir):
        return None
    events = (WindowEventLog(args.metrics_out + ".windows.jsonl")
              if args.metrics_out else None)
    return Obs(events=events, interval=args.obs_interval,
               annotate=bool(args.profile_dir), host=host)


def _join_group(args) -> str | None:
    """``--processes``/``--coordinator``: the JAX CLI's refusals, word
    for word, then join the group and suffix ``--metrics-out`` and
    ``--trace-out`` with this process's label.  Returns the label (None
    for one process)."""
    if not (args.processes > 1 or args.coordinator):
        return None
    if args.legacy:
        raise SystemExit("--processes runs the fused SPMD pipeline; "
                         "--legacy is single-process")
    if args.source == "table":
        raise SystemExit("--processes needs a streaming --source "
                         "(generated or memmap): every host "
                         "generates its own slice of each window")
    if args.shards > 0:
        raise SystemExit("--shards picks a device subset; with "
                         "--processes the mesh is always the full "
                         "process-spanning device set (drop "
                         "--shards)")
    if args.scenario == "tenants" and args.tenant_mode == "independent":
        raise SystemExit("--tenant-mode independent runs one "
                         "pipeline per tenant; compose with "
                         "--processes via shared or priced")
    resolve_device(args.device)  # no card: raise before joining
    if not mh.initialize(coordinator=args.coordinator,
                         num_processes=args.processes or None,
                         process_id=args.process_id, device=args.device):
        raise SystemExit("--processes > 1 needs a --coordinator "
                         "(or $GREENFLOW_COORDINATOR)")
    host = mh.host_label()
    for attr in ("metrics_out", "trace_out"):
        if getattr(args, attr):
            setattr(args, attr, getattr(args, attr) + "." + host)
    print(f"[serve] multihost: {mh.host_report(make_request_mesh())}")
    return host


def _refuse(args) -> None:
    """The JAX CLI's refusals, word for word."""
    if args.legacy and args.source != "table":
        raise SystemExit("--legacy indexes the materialized server; "
                         "the streaming --source forms have no "
                         "legacy loop")
    if args.legacy and args.scenario == "georegions":
        raise SystemExit("--scenario georegions has no legacy loop "
                         "(the router exists only in the fused pass)")
    if args.legacy and args.scenario == "geotenants":
        raise SystemExit("--scenario geotenants has no legacy loop "
                         "(the combined tenant x region pass exists "
                         "only in the fused pipeline)")


def _run(args, obs) -> tuple[float, float]:
    """Build the trained stack of ``--small`` with the source and
    scenario of ``args`` and serve it; returns the run's (revenue,
    FLOPs).  Without a card it raises before any training unless
    ``--device cpu``."""
    _refuse(args)
    dev = resolve_device(args.device)
    mesh = make_request_mesh()  # a joined group's: one shard a process
    if mesh.world == 1:
        mesh = (make_request_mesh(args.shards)
                if args.shards > 0 and not args.legacy else None)
    print("[serve] building world + training cascade & reward models ...")
    exp, server, params, rcfg = experiments.build_serving_stack(
        experiments.serve_config(small=args.small), verbose=True,
        device=dev)
    if mesh is not None:  # every process serves the same model
        print(f"[serve] reward params sha256 {mh.params_digest(params)}")
    stack = trained_stack(
        exp, server, params, rcfg, source=args.source, users=args.users,
        replay_dir=args.replay_dir, requests=args.requests,
        windows=args.windows, scenario=args.scenario,
        budget_frac=args.budget_frac, seed=args.seed, tenants=args.tenants,
        tenant_mode=args.tenant_mode, tenant_spread=tenant_spread(args),
        spike=args.spike, obs=obs, mesh=mesh)
    users = (len(stack.exp.ctx_eval) if args.source == "table"
             else getattr(stack.source, "n_users", args.users))
    print(f"[serve] device {stack.device}, {len(stack.sizes)} windows, "
          f"U={users:,}, budget {stack.budget:.4e} FLOPs/window")
    if args.legacy and args.scenario == "carbon":
        return legacy_carbon_day(stack, args)
    if args.legacy:
        return _legacy_loop(stack.exp, stack.server, stack.reward_params,
                            stack.reward_cfg, stack.sizes, stack.budget,
                            seed=args.seed)
    if args.scenario in DAYS:
        day = DAYS[args.scenario](stack, args, obs=obs)
        return day.total_revenue, day.total_flops
    if len(stack.pipelines) == 1:
        runs = [serve(stack, prefetch=args.prefetch, obs=obs)]
    else:
        runs = [serve(stack, prefetch=args.prefetch, pipeline=p, obs=obs)
                for p in stack.pipelines]
    c_min = float(stack.chains.costs.min())
    for k, st in enumerate(runs):
        if len(runs) > 1:
            print(f"[serve] tenant {k} (independent pipeline)")
        for line in window_table(st):
            print(line)
        print(f"[serve] {len(st.sizes)} windows in {st.wall_s:.2f}s, worst "
              f"overshoot vs cap: {st.overshoot(c_min) * 100:.3f}%, "
              f"revenue {st.total_revenue:.1f}")
    flops = sum(float(r.flops) for st in runs for r in st.windows)
    return sum(st.total_revenue for st in runs), flops


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    host = _join_group(args)
    try:
        return _main(args, host)
    finally:
        if host is not None:
            mh.shutdown()


def _main(args, host) -> int:
    obs = _make_obs(args, host)
    if args.profile_dir:
        acts = [ProfilerActivity.CPU]
        if args.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            total_rev, total_flops = _run(args, obs)
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[obs] torch.profiler trace -> {path}")
    else:
        total_rev, total_flops = _run(args, obs)
    print("\n[serve] PFEC (GreenFlow serving run):")
    for k, v in pfec_report(clicks=total_rev,
                            flops=total_flops).as_row().items():
        print(f"    {k:14s} {v}")
    if obs is not None:
        if args.metrics_out:
            prom, js = obs.export(args.metrics_out)
            print(f"[obs] metrics -> {prom} (+ {os.path.basename(js)})")
            if obs.events is not None:
                print(f"[obs] window log -> {obs.events.path} "
                      f"({obs.events.rows_written} rows)")
        if args.trace_out:
            path = obs.tracer.write(args.trace_out)
            print(f"[obs] trace -> {path} ({len(obs.tracer.events)} spans; "
                  f"open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
