"""The paper's offline experiment (§5.1-§5.2) on the port.

  1. a synthetic Ali-CCP-style world and the 50/5/25/20 user split;
  2. train the four cascade models (DSSM, YDNN, DIN, DIEN) on the click
     log of the cascade-train users - on the card DIN's gradient runs the
     ``target_attention`` backward kernel and YDNN's the
     ``embedding_bag`` one;
  3. score the whole corpus with every stage model (under ``no_grad``,
     on the trained trees, which never require gradients) and sample the
     ground-truth clicks once per (user, item);
  4. simulate EVERY action chain per user -> revenue matrices, the reward
     model's training samples;
  5. train the personalized reward model;
  6. evaluate GreenFlow against EQUAL, CRAS and the oracle at a sweep of
     budgets, revenue@e realized against the ground truth.

The JAX package's ``repro/experiments.py`` is the reference: the same
configs, seeds, batches (NumPy, bit for bit) and optimizers.  Weights
are drawn by the port's own inits from ``cfg.seed`` (torch generators),
so a port-built experiment is another draw of the same protocol; the
tests carry the JAX package's inits over to compare the two trainings
step for step.  Everything runs on ``device`` (the card unless
``device="cpu"``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.cascade.engine import (CascadeModels, CascadeServer,
                                        precompute_stage_scores,
                                        simulate_revenue_matrix)
from repro_torch.core.action_chain import (ActionChainSet, ModelInstance,
                                           StageSpec, generate_action_chains)
from repro_torch.core.baselines import (StageActionSpace, cras_allocation,
                                        equal_allocation)
from repro_torch.core.primal_dual import allocate, dual_bisect
from repro_torch.core.reward_model import (RewardModelConfig,
                                           chain_label_norm, field_rce,
                                           reward_matrix,
                                           reward_matrix_chunked,
                                           reward_model_init)
from repro_torch.data.synthetic import (World, WorldConfig, build_world,
                                        ctr_batch, split_users)
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys import dien, din, dssm, ydnn
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.trainer import (batch_to, build_train_step,
                                          init_state)
from repro_torch.tree import leaves

# the experiment cache: ``REPRO_TORCH_CACHE`` names another directory (the
# processes of one multi-process run share one trained stack through it)
CACHE = os.environ.get("REPRO_TORCH_CACHE") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "results",
    "torch", "cache")


@dataclass(frozen=True)
class ExperimentConfig:
    world: WorldConfig = WorldConfig(n_users=4000, n_items=600, hist_len=16)
    expose: int = 10  # e of revenue@e (paper: 20 at corpus 4000)
    n_scales: int = 6  # |N_2| = |N_3|
    cascade_steps: int = 250
    reward_steps: int = 600
    batch: int = 64
    seed: int = 0
    # the paper's split shifts mass from validation (unused offline) to
    # the final evaluation: realized-revenue comparisons need more than a
    # 2.5% slice at mini scale (as in the JAX package)
    split_fracs: tuple = (0.5, 0.05, 0.25, 0.2)
    # paper Table 1 FLOPs keep the budget axis in paper units
    flops: tuple = (13e3, 123e3, 7020e3, 7098e3)


def scaled_stage_specs(cfg: ExperimentConfig) -> tuple[StageSpec, ...]:
    """The paper's chain space with item scales proportional to the
    corpus: N2 in 20-37.5% and N3 in 1.5-5% where 5% of the corpus is at
    least 3 x expose; below that (mini corpora, where 1.5-5% collapses to
    about expose and the rank stage would expose top-e of e) N3 is
    stretched to [expose, 20%] and N2 to [20%, 50%]."""
    i = cfg.world.n_items
    if 0.05 * i >= 3 * cfg.expose:  # paper band is non-degenerate
        n2_band, n3_band = (0.20, 0.375), (0.015, 0.05)
    else:
        n2_band, n3_band = (0.20, 0.50), (0.015, 0.20)
    n2 = tuple(sorted({int(x) for x in
                       np.linspace(n2_band[0] * i, n2_band[1] * i,
                                   cfg.n_scales)}))
    n3 = tuple(sorted({max(cfg.expose, int(x)) for x in
                       np.linspace(max(cfg.expose, n3_band[0] * i),
                                   n3_band[1] * i, cfg.n_scales)}))
    f_dssm, f_ydnn, f_din, f_dien = cfg.flops
    return (
        StageSpec("recall", (ModelInstance("DSSM", f_dssm, auc=0.525),),
                  (i,), 4),
        StageSpec("prerank", (ModelInstance("YDNN", f_ydnn, auc=0.581),),
                  n2, 4),
        StageSpec("rank", (ModelInstance("DIN", f_din, auc=0.639),
                           ModelInstance("DIEN", f_dien, auc=0.641)),
                  n3, 4),
    )


@dataclass
class Experiment:
    cfg: ExperimentConfig
    world: World
    split: object
    chains: ActionChainSet
    models: CascadeModels
    clicks_eval: np.ndarray  # (U_eval, I) ground truth
    clicks_reward: np.ndarray  # (U_reward, I)
    revenue_eval: np.ndarray  # (U_eval, J) simulated true revenue
    revenue_reward: np.ndarray  # (U_reward, J)
    ctx_eval: np.ndarray
    ctx_reward: np.ndarray
    history: dict = field(default_factory=dict)  # model -> step losses


def models_device(models: CascadeModels) -> torch.device:
    return models.dssm_params["user_emb"]["table"].device


# ---------------------------------------------------------------------------
# Cascade model training
# ---------------------------------------------------------------------------


def stage_configs(world: World) -> tuple:
    """(DSSM, YDNN, DIN, DIEN) configs of the experiment's cascade.

    The recall tower is category-only and low-capacity on purpose: the
    paper's stage quality ladder (DSSM 0.525 < YDNN 0.581 < DIN/DIEN ~0.64
    AUC) only emerges at mini scale if recall generalizes coarsely
    instead of memorizing a few hundred item ids."""
    w = world.cfg
    n_uf = w.n_user_fields
    user_vocab = n_uf * w.user_field_vocab
    rank = dict(item_vocab=w.n_items, cat_vocab=w.n_cats,
                user_vocab=user_vocab, n_user_fields=n_uf, embed_dim=8,
                seq_len=w.hist_len, attn_hidden=(16, 8), mlp_hidden=(32, 16))
    return (dssm.DSSMConfig(user_vocab=user_vocab, item_vocab=w.n_items,
                            n_user_fields=n_uf, n_item_fields=1,
                            embed_dim=4, hidden=(16, 8), d_out=4),
            ydnn.YDNNConfig(item_vocab=w.n_items, user_vocab=user_vocab,
                            n_user_fields=n_uf, hist_len=w.hist_len,
                            embed_dim=8, hidden=(48, 24), d_out=12),
            din.DINConfig(**rank), dien.DIENConfig(**rank))


def dssm_loss(params, cfg: dssm.DSSMConfig, b: dict):
    """Two towers on (user fields, item category), cosine x 6 as the
    logit, BCE."""
    s = dssm.score(params, cfg, b["user_fields"],
                   b["item_cat"][:, None, None])[:, 0] * 6.0
    return L.sigmoid_bce(s, b["label"])


def ydnn_loss(params, cfg: ydnn.YDNNConfig, b: dict):
    """The user vector's dot with the item's output embedding as the
    logit, BCE; the history bag's gradient is the ``embedding_bag``
    backward."""
    s = ydnn.score(params, cfg, b["hist_ids"], b["hist_mask"],
                   b["user_fields"], b["item_id"][:, None])[:, 0]
    return L.sigmoid_bce(s, b["label"])


def _bind_cfg(loss, cfg):
    """``loss(params, cfg, batch)`` as a ``loss_fn(params, batch)``."""
    return lambda params, batch: loss(params, cfg, batch)


def _train_model(loss_fn, params, pipe_fn, steps, batch, seed, lr=3e-3):
    """``steps`` AdamW steps (weight decay 1e-5, cosine from ``lr`` with 20
    warmup steps, global-norm clip 1) on ``pipe_fn(rng)`` batches from
    ``np.random.default_rng(seed)``, on the parameters' device ->
    (trained parameters, per-step losses)."""
    opt = AdamW(weight_decay=1e-5)
    step = build_train_step(loss_fn, opt, cosine_schedule(lr, 20, steps))
    state = init_state(params, opt)
    dev = leaves(params)[0].device
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch_to(pipe_fn(rng), dev))
        losses.append(m["loss"])
    return state.params, [float(x) for x in losses]


def train_cascade_models(world: World, users: np.ndarray,
                         cfg: ExperimentConfig, *, device=None,
                         history: dict | None = None) -> CascadeModels:
    """The four stage models trained on ``users``' click log; DIN and
    DIEN take twice the steps (they carry the cascade's quality ceiling).
    Per-step losses go to ``history`` when given."""
    dev = resolve_device(device)
    dssm_cfg, ydnn_cfg, din_cfg, dien_cfg = stage_configs(world)
    gen = torch.Generator().manual_seed(cfg.seed)

    def pipe(rng):
        b = ctr_batch(world, users, rng, cfg.batch)
        b.pop("users")
        return b

    out = {}
    for name, mod, mcfg, loss, steps, seed in (
            ("DSSM", dssm, dssm_cfg, dssm_loss, cfg.cascade_steps, 1),
            ("YDNN", ydnn, ydnn_cfg, ydnn_loss, cfg.cascade_steps, 2),
            ("DIN", din, din_cfg, din.loss_fn, 2 * cfg.cascade_steps, 3),
            ("DIEN", dien, dien_cfg, dien.loss_fn, 2 * cfg.cascade_steps,
             4)):
        out[name], losses = _train_model(
            _bind_cfg(loss, mcfg), mod.init(gen, mcfg, dev), pipe, steps,
            cfg.batch, cfg.seed + seed)
        if history is not None:
            history[name] = losses
    return CascadeModels(out["DSSM"], dssm_cfg, out["YDNN"], ydnn_cfg,
                         out["DIN"], din_cfg, out["DIEN"], dien_cfg)


# ---------------------------------------------------------------------------
# Build the full experiment
# ---------------------------------------------------------------------------


def build_experiment(cfg: ExperimentConfig = ExperimentConfig(), *,
                     device=None, verbose: bool = False) -> Experiment:
    log = print if verbose else (lambda *a: None)
    world = build_world(cfg.world)
    split = split_users(world, seed=cfg.seed + 10, fracs=cfg.split_fracs)
    chains = generate_action_chains(scaled_stage_specs(cfg))
    log(f"[exp] world U={cfg.world.n_users} I={cfg.world.n_items} "
        f"J={chains.n_chains}")

    history: dict = {}
    models = train_cascade_models(world, split.cascade_train, cfg,
                                  device=device, history=history)
    log("[exp] cascade models trained")

    rng = np.random.default_rng(cfg.seed + 20)
    out = {}
    for name, users in (("eval", split.final_eval),
                        ("reward", split.reward_train)):
        scores = precompute_stage_scores(models, world, users)
        clicks = world.sample_clicks(
            users, np.tile(np.arange(world.cfg.n_items), (len(users), 1)),
            rng)
        rev = simulate_revenue_matrix(scores, chains, clicks,
                                      expose=cfg.expose)
        out[name] = (clicks, rev)
        log(f"[exp] simulated {name}: users={len(users)} "
            f"mean_rev={rev.mean():.3f}")

    return Experiment(
        cfg=cfg, world=world, split=split, chains=chains, models=models,
        clicks_eval=out["eval"][0], clicks_reward=out["reward"][0],
        revenue_eval=out["eval"][1], revenue_reward=out["reward"][1],
        ctx_eval=world.reward_context(split.final_eval),
        ctx_reward=world.reward_context(split.reward_train),
        history=history)


# ---------------------------------------------------------------------------
# Reward model training (paper §4.2 on simulated chain samples)
# ---------------------------------------------------------------------------


def reward_matrix_loss(params, rcfg: RewardModelConfig, model_onehot,
                       scale_multihot, b: dict):
    """MSE of the (B, J) reward matrix against the (B, J) labels."""
    pred = reward_matrix(params, rcfg, b["context"], model_onehot,
                         scale_multihot)
    return torch.mean(torch.square(pred - b["label"]))


def train_reward_model(exp: Experiment, *, recursive: bool = True,
                       multi_basis: bool = True, steps: int | None = None,
                       seed: int = 0, init: dict | None = None
                       ) -> tuple[dict, RewardModelConfig]:
    """Train the personalized reward model on the simulated chain
    revenues, on the cascade models' device.

    As in the JAX package: it fits the revenue RATIO rev_uj / mean_u
    rev_uj (the per-chain mean curve is stored as ``label_norm``, the
    network learns the per-user deviations GreenFlow allocates on), and
    each step regresses ALL J chains of a batch of users at once.
    ``init`` is the starting tree (default: ``reward_model_init`` from
    ``seed + 33``)."""
    cfg, chains = exp.cfg, exp.chains
    dev = models_device(exp.models)
    rcfg = RewardModelConfig(
        n_stages=chains.n_stages, max_models=2, n_scale_groups=4,
        d_context=exp.ctx_reward.shape[1], d_feature=32, d_hidden=32,
        d_state=16, recursive=recursive, multi_basis=multi_basis)
    params = (init if init is not None else reward_model_init(
        torch.Generator().manual_seed(seed + 33), rcfg, dev))
    steps = steps or cfg.reward_steps

    rev = exp.revenue_reward  # (U, J)
    mu = chain_label_norm(rev)  # (J,)
    labels = (rev / mu[None, :]).astype(np.float32)
    mo = torch.as_tensor(chains.model_onehot, device=dev)
    sh = torch.as_tensor(chains.scale_multihot, device=dev)

    def loss_fn(p, b):
        return reward_matrix_loss(p, rcfg, mo, sh, b)

    opt = AdamW(weight_decay=1e-5)
    step = build_train_step(loss_fn, opt, cosine_schedule(3e-3, 20, steps))
    state = init_state(params, opt)
    rng = np.random.default_rng(seed + 44)
    n_u = rev.shape[0]
    b_users = max(8, cfg.batch // 4)  # each user row carries all J labels
    for _ in range(steps):
        ui = rng.integers(0, n_u, b_users)
        state, _ = step(state, batch_to({"context": exp.ctx_reward[ui],
                                         "label": labels[ui]}, dev))
    out = dict(state.params)
    out["label_norm"] = torch.as_tensor(mu, device=dev)
    return out, rcfg


def predicted_rewards(exp: Experiment, params, rcfg, ctx) -> np.ndarray:
    """(U, J) predicted revenue, scored in chunks and de-normalized."""
    r = reward_matrix_chunked(params, rcfg, ctx, exp.chains.model_onehot,
                              exp.chains.scale_multihot)
    return r * params["label_norm"].cpu().numpy()[None, :]


def reward_model_metrics(exp: Experiment, params, rcfg) -> dict:
    """Field-RCE (paper Eq. 12; field = rank-stage scale group) and MSE on
    the held-out eval users."""
    pred = predicted_rewards(exp, params, rcfg, exp.ctx_eval)
    true = exp.revenue_eval
    k_rank = exp.chains.n_stages - 1
    groups = exp.chains.scale_multihot[:, k_rank].sum(-1).astype(int)
    fields = np.tile(groups, (true.shape[0], 1)).reshape(-1)
    rce = field_rce(true.reshape(-1), pred.reshape(-1), fields)
    mse = float(np.mean((pred - true) ** 2))
    return {"field_rce": rce, "mse": mse}


# ---------------------------------------------------------------------------
# Method evaluation (paper Fig. 4 / Tables 2-3 protocol), on the host
# ---------------------------------------------------------------------------


def _realized(exp: Experiment, decisions: np.ndarray) -> tuple[float, float]:
    rev = exp.revenue_eval[np.arange(len(decisions)), decisions].sum()
    spend = exp.chains.costs[decisions].sum()
    return float(rev), float(spend)


def budget_at(exp: Experiment, frac: float, n: int | None = None) -> float:
    """Budget at ``frac`` of the FEASIBLE range [floor, max]: Eq. 3b
    serves every request one chain, so n min(c) is the spend floor."""
    chains = exp.chains
    n = n if n is not None else exp.revenue_eval.shape[0]
    floor = chains.costs.min() * n
    return float(floor + frac * (chains.costs.max() * n - floor))


def _allocate_within(rewards: np.ndarray, costs, budget: float) -> np.ndarray:
    r = torch.as_tensor(rewards)
    lam = dual_bisect(r, costs, budget)
    return allocate(r, costs, lam).numpy()


def evaluate_methods(exp: Experiment, budgets_frac=(0.3, 0.5, 0.7, 0.9), *,
                     rewards_pred: np.ndarray | None = None,
                     stage_rewards: list | None = None) -> list[dict]:
    """Every method at each budget of the feasible range: the oracle
    (allocating on the true revenue), GreenFlow (on ``rewards_pred``),
    EQUAL-DIN/-DIEN and, with ``stage_rewards``, CRAS-DIN/-DIEN/-both."""
    chains = exp.chains
    costs = torch.as_tensor(chains.costs, dtype=torch.float32)
    n = exp.revenue_eval.shape[0]
    rows = []
    for frac in budgets_frac:
        budget = budget_at(exp, frac)
        row = {"budget_frac": frac, "budget_flops": budget}
        dec = _allocate_within(exp.revenue_eval, costs, budget)
        row["oracle"], row["oracle_spend"] = _realized(exp, dec)
        if rewards_pred is not None:
            dec = _allocate_within(rewards_pred, costs, budget)
            row["greenflow"], row["greenflow_spend"] = _realized(exp, dec)
        for mname in ("DIN", "DIEN"):
            j = equal_allocation(chains, budget, n, rank_model=mname)
            row[f"equal_{mname.lower()}"], _ = _realized(
                exp, np.full(n, j, np.int32))
        if stage_rewards is not None:
            spaces = [StageActionSpace.from_chains(chains, k)
                      for k in range(chains.n_stages)]
            for mname in ("DIN", "DIEN", None):
                key = f"cras_{mname.lower()}" if mname else "cras_both"
                dec = cras_allocation(stage_rewards, spaces, chains, budget,
                                      rank_model=mname)
                row[key], _ = _realized(exp, dec)
        rows.append(row)
    return rows


def cras_stage_rewards(exp: Experiment, ctx_users: str = "eval") -> list:
    """Per-stage independent reward estimates (Yang et al. 2021 setup):
    a stage action's value is the mean true revenue over the chains that
    share it, estimated from the reward-train users and applied per
    request by a nearest-context lookup (k = 8)."""
    chains = exp.chains
    rev_tr = exp.revenue_reward  # (U_tr, J)
    ctx_tr = exp.ctx_reward
    ctx_ev = exp.ctx_eval if ctx_users == "eval" else ctx_tr
    d = ((ctx_ev[:, None, :] - ctx_tr[None, :, :]) ** 2).sum(-1)
    nn = np.argsort(d, axis=1)[:, :8]  # (U_ev, 8)
    rev_ev_est = rev_tr[nn].mean(axis=1)  # (U_ev, J)
    out = []
    for k in range(chains.n_stages):
        sp = StageActionSpace.from_chains(chains, k)
        cols = []
        for mi, si in sp.actions:
            mask = (chains.chain_idx[:, k, 0] == mi) & \
                   (chains.chain_idx[:, k, 1] == si)
            cols.append(rev_ev_est[:, mask].mean(axis=1))
        out.append(torch.as_tensor(np.stack(cols, axis=1),
                                   dtype=torch.float32))
    return out


# ---------------------------------------------------------------------------
# The serving universe
# ---------------------------------------------------------------------------


def serve_config(*, small: bool = False) -> ExperimentConfig:
    """The serving demo's world (the JAX CLI's ``--small`` flag)."""
    return ExperimentConfig(
        world=WorldConfig(n_users=800 if small else 2000,
                          n_items=200 if small else 400,
                          hist_len=10, seed=11),
        expose=8, n_scales=4,
        cascade_steps=100 if small else 200,
        reward_steps=200 if small else 400, batch=48)


def _cache_path(cfg: ExperimentConfig, dev: torch.device) -> str:
    w = cfg.world
    key = (f"serve_u{w.n_users}_i{w.n_items}_h{w.hist_len}_ws{w.seed}"
           f"_s{cfg.seed}_c{cfg.cascade_steps}_e{cfg.expose}"
           f"_ns{cfg.n_scales}_b{cfg.batch}_r{cfg.reward_steps}"
           f"_{dev.type}.pkl")
    return os.path.join(CACHE, key)


def build_serving_stack(cfg: ExperimentConfig | None = None, *,
                        small: bool = False, cache: bool = True,
                        verbose: bool = False, device=None):
    """Experiment + trained reward model + ``CascadeServer`` over the eval
    users -> (exp, server, reward params, reward config), on ``device``.

    The built experiment (not the reward model, which trains in seconds)
    is pickled under ``results/torch/cache/`` with its models on the CPU,
    keyed by every size-relevant field and the device type (a card-trained
    experiment is another one than a CPU-trained one), written to a
    temporary file and renamed into place."""
    dev = resolve_device(device)
    cfg = cfg or serve_config(small=small)
    exp = None
    path = _cache_path(cfg, dev) if cache else None
    if path is not None and os.path.exists(path):
        with open(path, "rb") as f:
            exp = pickle.load(f)
        exp.models = CascadeModels(*(
            L.to_device(x, dev) if isinstance(x, dict) else x
            for x in vars(exp.models).values()))
    if exp is None:
        exp = build_experiment(cfg, device=dev, verbose=verbose)
        if path is not None:
            os.makedirs(CACHE, exist_ok=True)
            on_cpu = CascadeModels(*(
                L.to_device(x, "cpu") if isinstance(x, dict) else x
                for x in vars(exp.models).values()))
            # a file of its own, then renamed into place: processes that
            # build the same experiment at once never read a partial one
            fd, tmp = tempfile.mkstemp(dir=CACHE, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(Experiment(**{**vars(exp),
                                              "models": on_cpu}), f)
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
    params, rcfg = train_reward_model(exp)
    scores = precompute_stage_scores(exp.models, exp.world,
                                     exp.split.final_eval)
    server = CascadeServer(scores, exp.chains, exp.clicks_eval,
                           expose=cfg.expose, device=dev)
    return exp, server, params, rcfg
