"""DSSM (Huang et al., CIKM'13) - two-tower recall model.

Recall stage of the paper's cascade: candidate scoring is one dot
product once the towers are computed; the item tower runs once for the
whole corpus.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.flops import dense_flops, mlp_flops
from repro_torch.models import layers as L


@dataclass(frozen=True)
class DSSMConfig:
    user_vocab: int = 200_000  # hashed user categorical ids
    item_vocab: int = 100_000
    n_user_fields: int = 4
    n_item_fields: int = 2
    embed_dim: int = 16
    hidden: tuple = (128, 64)
    d_out: int = 32


def init(gen: torch.Generator, cfg: DSSMConfig, device=None) -> dict:
    d_user_in = cfg.n_user_fields * cfg.embed_dim
    d_item_in = cfg.n_item_fields * cfg.embed_dim
    return L.to_device({
        "user_emb": L.embedding_init(gen, cfg.user_vocab, cfg.embed_dim),
        "item_emb": L.embedding_init(gen, cfg.item_vocab, cfg.embed_dim),
        "user_tower": L.mlp_init(gen, [d_user_in, *cfg.hidden, cfg.d_out]),
        "item_tower": L.mlp_init(gen, [d_item_in, *cfg.hidden, cfg.d_out]),
    }, device or "cpu")


def _tower(emb, tower, fields):
    e = L.embedding_apply(emb, fields)  # (..., F, D)
    e = e.reshape(*e.shape[:-2], -1)
    v = L.mlp_apply(tower, e, act="relu")
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-6)


def user_tower(params, cfg: DSSMConfig, user_fields):
    """user_fields (B, n_user_fields) int -> (B, d_out)."""
    return _tower(params["user_emb"], params["user_tower"], user_fields)


def item_tower(params, cfg: DSSMConfig, item_fields):
    """item_fields (..., n_item_fields) int -> (..., d_out)."""
    return _tower(params["item_emb"], params["item_tower"], item_fields)


def score(params, cfg: DSSMConfig, user_fields, item_fields):
    """user (B, Fu), items (B, N, Fi) -> cosine scores (B, N)."""
    u = user_tower(params, cfg, user_fields)
    v = item_tower(params, cfg, item_fields)
    return torch.einsum("bd,bnd->bn", u, v)


def flops_per_item(cfg: DSSMConfig) -> float:
    """Online cost to score ONE candidate = one d_out dot."""
    return dense_flops(cfg.d_out, 1, use_bias=False)


def flops_per_request(cfg: DSSMConfig, n_items: int) -> float:
    d_user_in = cfg.n_user_fields * cfg.embed_dim
    tower = mlp_flops([d_user_in, *cfg.hidden, cfg.d_out])
    return tower + n_items * flops_per_item(cfg)
