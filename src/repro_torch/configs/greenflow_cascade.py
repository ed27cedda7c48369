"""greenflow-cascade: the paper's own system as cells.

Four serving and nearline programs, the ones that run in front of a
production recommender:

  reward_serve  - the online module: ``reward_matrix`` over B = 4,096
                  requests x J = 128 action chains, then the Eq. 10
                  decision; returns (decisions, rewards);
  nearline_dual - the nearline module: 200 dual-descent steps (Algorithm
                  1) over a 65,536-request window; returns (lambda, the
                  (200,) gap trace);
  reward_train  - the reward model's train step (B = 8,192, AdamW, lr
                  1e-3, no clipping); returns (state, loss);
  rank_serve    - the cascade's rank stage under allocation: B = 1,024
                  requests x 200 candidates through DIN at the JAX
                  cell's production id spaces (10 M items, 100 K
                  categories, 1 M user rows: a 720 MB f32 item table),
                  through the ``target_attention`` kernel.

The chains are ``paper_stage_specs``'s.  ``meta["model_flops"]`` counts
as the JAX package's cells do.  ``smoke_config()`` narrows the reward
model, and a cell made with it runs at ``SMOKE_SIZES`` with DIN's smoke
widths, small enough for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import din_arch
from repro_torch.configs.base import Cell
from repro_torch.core.action_chain import (generate_action_chains,
                                           paper_stage_specs)
from repro_torch.core.primal_dual import allocate, dual_descent
from repro_torch.core.reward_model import (RewardModelConfig, reward_loss,
                                           reward_matrix, reward_model_init)
from repro_torch.device import resolve_device
from repro_torch.models.recsys import din as din_model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.trainer import (TrainState, init_state,
                                          value_and_grad)

ARCH_ID = "greenflow-cascade"
FAMILY = "recsys"
SHAPES = ("reward_serve", "nearline_dual", "reward_train", "rank_serve")
SKIPPED_SHAPES: dict = {}

D_CONTEXT = 32
NEARLINE_ITERS = 200
TRAIN_LR = 1e-3
# requests of each cell: the JAX cells' sizes, and the smoke cells'
FULL_SIZES = dict(reward_serve=4096, nearline_dual=65_536,
                  reward_train=8192, rank_batch=1024, rank_cands=200)
SMOKE_SIZES = dict(reward_serve=64, nearline_dual=256, reward_train=64,
                   rank_batch=4, rank_cands=20)


def full_config() -> RewardModelConfig:
    chains = generate_action_chains(paper_stage_specs())
    return RewardModelConfig(
        n_stages=chains.n_stages, max_models=2, n_scale_groups=4,
        d_context=D_CONTEXT, d_feature=64, d_hidden=64, d_state=32)


def smoke_config() -> RewardModelConfig:
    return RewardModelConfig(n_stages=3, max_models=2, n_scale_groups=4,
                             d_context=8, d_feature=16, d_hidden=16,
                             d_state=8)


def rank_config(cfg: RewardModelConfig) -> din_model.DINConfig:
    """DIN of ``rank_serve``: the JAX cell's, or DIN's smoke widths."""
    if cfg == smoke_config():
        return din_arch.smoke_config()
    return din_model.DINConfig(item_vocab=10_000_000, cat_vocab=100_000,
                               user_vocab=1_000_000)


def cell_sizes(cfg: RewardModelConfig) -> dict:
    return SMOKE_SIZES if cfg == smoke_config() else FULL_SIZES


# smoke ----------------------------------------------------------------------


def init_smoke(gen, cfg: RewardModelConfig, device=None) -> dict:
    return reward_model_init(gen, cfg, device)


def _reward_batch(rng: np.random.Generator, cfg: RewardModelConfig, b: int,
                  device) -> dict:
    """The JAX smoke batch's arrays, drawn in its order: one model a
    stage, a cumulative scale multi-hot, contexts and labels."""
    k, m, q = cfg.n_stages, cfg.max_models, cfg.n_scale_groups
    mo = np.zeros((b, k, m), np.float32)
    mo[np.arange(b)[:, None], np.arange(k)[None, :],
       rng.integers(0, m, (b, k))] = 1.0
    sh = np.cumsum(np.eye(q)[rng.integers(0, q, (b, k))][..., ::-1],
                   axis=-1)[..., ::-1]
    arrays = {"context": rng.normal(size=(b, cfg.d_context)),
              "model_onehot": mo, "scale_multihot": sh,
              "label": rng.uniform(0, 5, b)}
    return {name: torch.as_tensor(np.asarray(a, np.float32),
                                  device=device or "cpu")
            for name, a in arrays.items()}


def smoke_batch(rng: np.random.Generator, cfg: RewardModelConfig,
                device=None) -> dict:
    return _reward_batch(rng, cfg, 16, device)


def smoke_loss(params, cfg: RewardModelConfig, batch: dict):
    return reward_loss(params, cfg, batch)


# cells ----------------------------------------------------------------------


def make_cell(shape: str, cfg: RewardModelConfig | None = None) -> Cell:
    cfg = cfg or full_config()
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; have {sorted(SHAPES)}")
    sizes = cell_sizes(cfg)
    chains = generate_action_chains(paper_stage_specs())
    j = chains.n_chains

    def params_on(seed: int, device):
        return reward_model_init(torch.Generator().manual_seed(seed), cfg,
                                 device)

    def chain_tensors(device):
        return (torch.as_tensor(chains.model_onehot, device=device),
                torch.as_tensor(chains.scale_multihot, device=device),
                torch.as_tensor(chains.costs, dtype=torch.float32,
                                device=device))

    if shape == "reward_serve":
        n = sizes["reward_serve"]

        def make_args(seed: int, device=None):
            device = resolve_device(device)
            mo, sh, costs = chain_tensors(device)
            ctx = np.random.default_rng(seed).normal(size=(n, cfg.d_context))
            # a price that makes reward and cost terms comparable
            lam = torch.tensor(1.0 / float(chains.costs.mean()),
                               device=device)
            return (params_on(seed, device),
                    torch.as_tensor(ctx.astype(np.float32), device=device),
                    lam, mo, sh, costs)

        @torch.no_grad()
        def fn(params, ctx, lam, mo, sh, costs):
            r = reward_matrix(params, cfg, ctx, mo, sh)
            return allocate(r, costs, lam), r

        flops = n * j * cfg.n_stages * 2.0 * (
            cfg.d_hidden * (cfg.d_state + cfg.d_feature + 8)
            + cfg.d_hidden * cfg.d_hidden)
        return Cell(ARCH_ID, shape, "serve", fn, make_args,
                    {"model_flops": flops, "batch": n,
                     "outputs": ("decisions", "rewards")})

    if shape == "nearline_dual":
        n = sizes["nearline_dual"]
        budget = float(chains.costs.mean()) * n

        def make_args(seed: int, device=None):
            device = resolve_device(device)
            # rewards that grow with the chain's cost, so the window at
            # a zero price spends over its budget and the price moves
            rewards = (np.random.default_rng(seed).uniform(0, 1, (n, j))
                       + 4.0 * chains.costs / chains.costs.max())
            return (torch.as_tensor(rewards.astype(np.float32),
                                    device=device),
                    torch.zeros((), device=device), chain_tensors(device)[2])

        @torch.no_grad()
        def fn(rewards, lam0, costs):
            return dual_descent(rewards, costs, budget, lam0,
                                max_iters=NEARLINE_ITERS)

        return Cell(ARCH_ID, shape, "serve", fn, make_args,
                    {"model_flops": NEARLINE_ITERS * n * j * 4.0,
                     "batch": n, "outputs": ("lambda", "gaps")})

    if shape == "reward_train":
        n = sizes["reward_train"]
        opt = AdamW()

        def step(state: TrainState, batch: dict):
            loss, grads = value_and_grad(
                lambda p, b: reward_loss(p, cfg, b), state.params, batch)
            new_params, new_opt = opt.update(grads, state.opt_state,
                                             state.params, TRAIN_LR)
            return TrainState(state.step + 1, new_params, new_opt), loss

        def make_args(seed: int, device=None):
            device = resolve_device(device)
            return (init_state(params_on(seed, device), opt),
                    _reward_batch(np.random.default_rng(seed), cfg, n,
                                  device))

        return Cell(ARCH_ID, shape, "train", step, make_args,
                    {"model_flops": 3.0 * n * cfg.n_stages * 2.0
                     * cfg.d_hidden * cfg.d_hidden * 4, "batch": n})

    dcfg = rank_config(cfg)
    b, n = sizes["rank_batch"], sizes["rank_cands"]

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        user = {k: torch.as_tensor(v, device=device)
                for k, v in din_arch._user(rng, dcfg, b).items()}
        cid = rng.integers(0, dcfg.item_vocab, (b, n)).astype(np.int32)
        ccat = rng.integers(0, dcfg.cat_vocab, (b, n)).astype(np.int32)
        params = din_model.init(torch.Generator().manual_seed(seed), dcfg,
                                device=device)
        return (params, user, torch.as_tensor(cid, device=device),
                torch.as_tensor(ccat, device=device))

    @torch.no_grad()
    def fn(params, user, cid, ccat):
        return din_model.score(params, dcfg, user, cid, ccat)

    return Cell(ARCH_ID, shape, "serve", fn, make_args,
                {"model_flops": b * n * din_model.flops_per_item(dcfg),
                 "batch": b, "candidates": n})
