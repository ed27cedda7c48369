"""YoutubeDNN (Covington et al., RecSys'16) - pre-ranking model.

User tower: mean-pooled watch-history embeddings (the ``embedding_bag``
kernel) + profile fields -> MLP.  Scoring: dot(user_vector, item_emb).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.flops import dense_flops, mlp_flops
from repro_torch.models import layers as L
from repro_torch.models.embedding import fixed_bag


@dataclass(frozen=True)
class YDNNConfig:
    item_vocab: int = 100_000
    n_user_fields: int = 4
    user_vocab: int = 200_000
    hist_len: int = 50
    embed_dim: int = 32
    hidden: tuple = (256, 128)
    d_out: int = 64


def init(gen: torch.Generator, cfg: YDNNConfig, device=None) -> dict:
    d_in = cfg.embed_dim + cfg.n_user_fields * cfg.embed_dim
    return L.to_device({
        "item_emb": L.embedding_init(gen, cfg.item_vocab, cfg.embed_dim),
        "user_emb": L.embedding_init(gen, cfg.user_vocab, cfg.embed_dim),
        "tower": L.mlp_init(gen, [d_in, *cfg.hidden, cfg.d_out]),
        "out_emb": L.embedding_init(gen, cfg.item_vocab, cfg.d_out),
    }, device or "cpu")


def user_vector(params, cfg: YDNNConfig, hist_ids, hist_mask, user_fields):
    """hist (B, T), mask (B, T), user_fields (B, F) -> (B, d_out)."""
    hist = fixed_bag(params["item_emb"]["table"], hist_ids, hist_mask,
                     mode="mean")  # (B, D)
    prof = L.embedding_apply(params["user_emb"], user_fields)
    prof = prof.reshape(*prof.shape[:-2], -1)
    x = torch.cat([hist, prof], dim=-1)
    return L.mlp_apply(params["tower"], x, act="relu")


def score(params, cfg: YDNNConfig, hist_ids, hist_mask, user_fields,
          item_ids):
    """item_ids (B, N) -> (B, N) scores."""
    u = user_vector(params, cfg, hist_ids, hist_mask, user_fields)
    v = L.embedding_apply(params["out_emb"], item_ids)  # (B, N, d)
    return torch.einsum("bd,bnd->bn", u, v)


def flops_per_item(cfg: YDNNConfig) -> float:
    return dense_flops(cfg.d_out, 1, use_bias=False)


def flops_per_request(cfg: YDNNConfig, n_items: int) -> float:
    d_in = cfg.embed_dim + cfg.n_user_fields * cfg.embed_dim
    tower = mlp_flops([d_in, *cfg.hidden, cfg.d_out])
    pool = cfg.hist_len * cfg.embed_dim
    return tower + pool + n_items * flops_per_item(cfg)
