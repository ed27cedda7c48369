"""Personalized reward model (paper §4.2): inference, and the loss,
label normalization and calibration metric of its training.

Recursive multi-stage design:  R_ij = sum_k dr_k with
    (dr_k, h_k) = g_k(h_{k-1}, f_i, m_k, n_k)

Each cell g_k mixes the basis functions of Eq. 7 with softmax weights
(Eq. 5) over softplus group scores dotted with the monotone multi-hot
scale code (Eq. 6).  The parameter tree matches the JAX package's, so
trained weights arrive through ``repro_torch.bridge``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

BASIS_FUNCTIONS = (
    ("tanh", torch.tanh),
    ("ln", torch.log1p),
    ("rsqrt1p", lambda x: x * torch.rsqrt(1.0 + x * x)),
    ("sigmoid", torch.sigmoid),
    ("identity", lambda x: x),
)
N_BASIS = len(BASIS_FUNCTIONS)


def apply_bases(v):
    """v: (..., P) -> phi_p(v_p) stacked on the last axis, P == N_BASIS."""
    return torch.stack([fn(v[..., p])
                        for p, (_, fn) in enumerate(BASIS_FUNCTIONS)],
                       dim=-1)


@dataclass(frozen=True)
class RewardModelConfig:
    n_stages: int  # K: decision stages
    max_models: int  # width of the per-stage model one-hot
    n_scale_groups: int  # Q
    d_context: int  # raw context feature dim fed to the encoder
    d_feature: int = 64  # encoded f_i dim
    d_hidden: int = 64  # trunk width inside each cell
    d_state: int = 32  # h_k carried between stages
    d_model_emb: int = 8  # model-instance embedding dim
    recursive: bool = True  # ablation: thread h_k between stages
    multi_basis: bool = True  # ablation: Eq. 5-7 vs plain MLP head
    encoder_hidden: tuple = (128,)


def _cell_init(gen, cfg: RewardModelConfig) -> dict:
    d_in = cfg.d_state + cfg.d_feature + cfg.d_model_emb
    p = {
        "trunk": L.mlp_init(gen, [d_in, cfg.d_hidden, cfg.d_hidden]),
        "state": L.dense_init(gen, cfg.d_hidden, cfg.d_state),
        "model_emb": L.normal_init(gen, (cfg.max_models, cfg.d_model_emb)),
    }
    if cfg.multi_basis:
        p["w_head"] = L.dense_init(gen, cfg.d_hidden, N_BASIS)
        p["v_heads"] = L.dense_init(gen, cfg.d_hidden,
                                    N_BASIS * cfg.n_scale_groups)
    else:
        p["flat_head"] = L.mlp_init(
            gen, [cfg.d_hidden + cfg.n_scale_groups, cfg.d_hidden, 1])
    return p


def reward_model_init(gen: torch.Generator, cfg: RewardModelConfig,
                      device=None) -> dict:
    enc_dims = [cfg.d_context, *cfg.encoder_hidden, cfg.d_feature]
    return L.to_device({
        "encoder": L.mlp_init(gen, enc_dims),
        "cells": [_cell_init(gen, cfg) for _ in range(cfg.n_stages)],
    }, device or "cpu")


def encode_context(params: dict, raw_context):
    """raw_context: (..., d_context) -> f_i: (..., d_feature)."""
    return L.mlp_apply(params["encoder"], raw_context, act="relu")


def _dr(cell, cfg: RewardModelConfig, t, scale_multihot):
    """Stage reward from the trunk output t (..., d_hidden) and the
    scale code (..., Q) - Eq. 5-7, or the plain-MLP ablation."""
    if cfg.multi_basis:
        w = torch.softmax(L.dense_apply(cell["w_head"], t), dim=-1)
        u = F.softplus(L.dense_apply(cell["v_heads"], t))
        u = u.reshape(*u.shape[:-1], N_BASIS, cfg.n_scale_groups)
        v = torch.einsum("...pq,...q->...p", u, scale_multihot)  # Eq. 6
        return torch.sum(w * apply_bases(v), dim=-1)  # Eq. 5
    zz = torch.cat([t, scale_multihot], dim=-1)
    return F.softplus(L.mlp_apply(cell["flat_head"], zz, act="relu")[..., 0])


def _cell_apply(cell: dict, cfg: RewardModelConfig, h, f, model_onehot,
                scale_multihot):
    """One g_k. Shapes: h (..., d_state), f (..., d_feature),
    model_onehot (..., max_models), scale_multihot (..., Q)."""
    m_emb = model_onehot @ cell["model_emb"]
    z = torch.cat([h, f, m_emb], dim=-1)
    t = L.mlp_apply(cell["trunk"], z, act="relu", final_act="relu")
    h_new = torch.tanh(L.dense_apply(cell["state"], t))
    return _dr(cell, cfg, t, scale_multihot), h_new


def reward_apply(params: dict, cfg: RewardModelConfig, raw_context,
                 model_onehot, scale_multihot):
    """Reward of ONE chain per request: context (B, d_context),
    model_onehot (B, K, M), scale_multihot (B, K, Q) -> (B,)."""
    f = encode_context(params, raw_context)
    h = torch.zeros(*f.shape[:-1], cfg.d_state, dtype=f.dtype,
                    device=f.device)
    total = torch.zeros(f.shape[:-1], dtype=f.dtype, device=f.device)
    for k in range(cfg.n_stages):
        dr, h_new = _cell_apply(params["cells"][k], cfg, h, f,
                                model_onehot[..., k, :],
                                scale_multihot[..., k, :])
        total = total + dr
        if cfg.recursive:
            h = h_new
    return total


def reward_matrix(params: dict, cfg: RewardModelConfig, raw_context,
                  chain_model_onehot, chain_scale_multihot):
    """Every request against every chain: (I, d_context) contexts,
    (J, K, M) one-hots, (J, K, Q) codes -> (I, J)."""
    f = encode_context(params, raw_context)  # (I, d_f)
    i_n, j_n = f.shape[0], chain_model_onehot.shape[0]
    fj = f[:, None, :].expand(i_n, j_n, f.shape[-1])
    h = torch.zeros(i_n, j_n, cfg.d_state, dtype=f.dtype, device=f.device)
    total = torch.zeros(i_n, j_n, dtype=f.dtype, device=f.device)
    for k in range(cfg.n_stages):
        mo = chain_model_onehot[None, :, k, :].expand(i_n, j_n, -1)
        sh = chain_scale_multihot[None, :, k, :].expand(i_n, j_n, -1)
        dr, h_new = _cell_apply(params["cells"][k], cfg, h, fj, mo, sh)
        total = total + dr
        if cfg.recursive:
            h = h_new
    return total


@torch.no_grad()
def reward_matrix_chunked(params: dict, cfg: RewardModelConfig, raw_context,
                          chain_model_onehot, chain_scale_multihot, *,
                          chunk: int = 2048) -> np.ndarray:
    """``reward_matrix`` over ``chunk`` requests at a time -> (I, J) NumPy:
    peak memory O(chunk * J) however many requests.  The last chunk is
    padded to ``chunk`` rows and sliced back, as the JAX package pads it,
    so every call has one shape.  Runs on the parameters' device."""
    dev = params["encoder"]["layers"][0]["w"].device
    ctx = np.asarray(raw_context, np.float32)
    mo = torch.as_tensor(np.asarray(chain_model_onehot), device=dev)
    sh = torch.as_tensor(np.asarray(chain_scale_multihot), device=dev)

    def run(c):
        return reward_matrix(params, cfg, torch.from_numpy(c).to(dev), mo,
                             sh).cpu().numpy()

    if ctx.shape[0] <= chunk:
        return run(ctx)
    parts = []
    for lo in range(0, ctx.shape[0], chunk):
        sl = ctx[lo:lo + chunk]
        pad = chunk - sl.shape[0]
        if pad:
            sl = np.concatenate([sl, np.zeros((pad, sl.shape[1]),
                                              np.float32)])
        parts.append(run(sl)[:chunk - pad])
    return np.concatenate(parts, axis=0)


# ---------------------------------------------------------------------------
# Model-prefix grouped scoring (the serving window's hot path)
# ---------------------------------------------------------------------------
#
# The recursive state h_k depends on the MODEL choices of stages <= k
# only (scales enter through the basis head alone), so each cell runs
# once per distinct model prefix and dr is broadcast to the chains that
# share it.


def chain_prefix_plan(chain_model_idx: np.ndarray) -> tuple:
    """Static dedup plan from the (J, K) per-stage model indices: one
    (model_of_prefix, parent_prefix, chain_to_prefix) triple per stage."""
    chain_model_idx = np.asarray(chain_model_idx)
    j_n, k_n = chain_model_idx.shape
    plan = []
    prev_rows: list[tuple] = [()]
    for k in range(k_n):
        pref, inv = np.unique(chain_model_idx[:, :k + 1], axis=0,
                              return_inverse=True)
        prev_map = {r: i for i, r in enumerate(prev_rows)}
        parent = np.asarray([prev_map[tuple(r[:-1])] for r in pref],
                            np.int64)
        plan.append((pref[:, -1].astype(np.int64), parent,
                     inv.astype(np.int64).reshape(j_n)))
        prev_rows = [tuple(r) for r in pref]
    return tuple(plan)


def device_prefix_plan(plan: tuple, device) -> tuple:
    """``chain_prefix_plan``'s index arrays as int64 tensors on
    ``device``, made once: ``reward_matrix_grouped`` then copies nothing
    from the host, so a CUDA graph can capture it."""
    return tuple(tuple(torch.as_tensor(np.asarray(a, np.int64),
                                       device=device) for a in triple)
                 for triple in plan)


def reward_matrix_grouped(params: dict, cfg: RewardModelConfig,
                          raw_context, chain_scale_multihot,
                          plan: tuple):
    """(I, J) rewards with per-stage model-prefix deduplication; ``plan``
    comes from ``chain_prefix_plan`` on ``chain_idx[:, :, 0]``, as NumPy
    arrays or already on the device (``device_prefix_plan``)."""
    f = encode_context(params, raw_context)  # (I, d_f)
    i_n = f.shape[0]
    j_n = chain_scale_multihot.shape[0]
    dev = f.device
    h = torch.zeros(i_n, 1, cfg.d_state, dtype=f.dtype, device=dev)
    total = torch.zeros(i_n, j_n, dtype=f.dtype, device=dev)
    for k, triple in enumerate(plan):
        model_of_prefix, parent, to_prefix = (torch.as_tensor(a, device=dev)
                                              for a in triple)
        cell = params["cells"][k]
        n_p = len(model_of_prefix)
        # one carried state (stage 0, or no recursion) is every prefix's
        h_p = (h[:, parent, :] if h.shape[1] > 1
               else h.expand(i_n, n_p, cfg.d_state))
        z = torch.cat([
            h_p,
            f[:, None, :].expand(i_n, n_p, f.shape[-1]),
            cell["model_emb"][model_of_prefix]
            [None].expand(i_n, n_p, cfg.d_model_emb),
        ], dim=-1)
        t = L.mlp_apply(cell["trunk"], z, act="relu", final_act="relu")
        sh_k = chain_scale_multihot[:, k, :]  # (J, Q)
        if cfg.multi_basis:
            w = torch.softmax(L.dense_apply(cell["w_head"], t), dim=-1)
            u = F.softplus(L.dense_apply(cell["v_heads"], t))
            u = u.reshape(i_n, n_p, N_BASIS, cfg.n_scale_groups)
            v = torch.einsum("ijpq,jq->ijp", u[:, to_prefix], sh_k)
            dr = torch.sum(w[:, to_prefix] * apply_bases(v), dim=-1)
        else:
            zz = torch.cat([t[:, to_prefix],
                            sh_k[None].expand(i_n, j_n, sh_k.shape[-1])],
                           dim=-1)
            dr = F.softplus(
                L.mlp_apply(cell["flat_head"], zz, act="relu")[..., 0])
        total = total + dr
        if cfg.recursive:
            h = torch.tanh(L.dense_apply(cell["state"], t))
    return total


def denormalize_rewards(params: dict, r):
    """Scale ratio predictions (.., J) back to revenue units when the
    params carry a ``label_norm`` (no-op otherwise)."""
    norm = params.get("label_norm")
    if norm is None:
        return r
    return r * norm[None, :]


# ---------------------------------------------------------------------------
# Per-chain label normalization, the training loss, the calibration metric
# ---------------------------------------------------------------------------
#
# The multi-basis head is non-negative and monotone by construction, so the
# trainer fits the ratio y_uj = rev_uj / mean_u(rev_uj): the per-chain mean
# curve is stored in params["label_norm"] and predictions de-normalize
# back to revenue units (``denormalize_rewards``).


def chain_label_norm(revenue: np.ndarray, floor: float = 1e-3) -> np.ndarray:
    """Per-chain mean revenue over training users -> (J,) norm vector."""
    return np.maximum(np.asarray(revenue).mean(axis=0), floor) \
        .astype(np.float32)


def reward_loss(params: dict, cfg: RewardModelConfig, batch: dict):
    """MSE on realized chain rewards.  batch = {context (B, dc),
    model_onehot (B, K, M), scale_multihot (B, K, Q), label (B,),
    [weight (B,)]}."""
    pred = reward_apply(params, cfg, batch["context"], batch["model_onehot"],
                        batch["scale_multihot"])
    err = torch.square(pred - batch["label"])
    w = batch.get("weight")
    if w is None:
        return torch.mean(err)
    return torch.mean(err * w) / torch.clamp(torch.mean(w), min=1e-8)


def field_rce(y_true: np.ndarray, y_pred: np.ndarray,
              field_values: np.ndarray) -> float:
    """Field-level relative calibration error (paper Eq. 12, Pan et al.):
    (1/|D|) sum_f |sum_{i in D_f} (y_i - yhat_i)| / mean_{i in D_f} y_i."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    field_values = np.asarray(field_values)
    total = 0.0
    for f in np.unique(field_values):
        m = field_values == f
        mean_y = y_true[m].mean()
        if mean_y <= 0:
            continue
        total += abs((y_true[m] - y_pred[m]).sum()) / mean_y
    return float(total / max(1, len(y_true)))
