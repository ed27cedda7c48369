"""DIN - Deep Interest Network (Zhou et al., KDD'18), the rank model.

Published config [arXiv:1706.06978]: embed_dim=18, seq_len=100,
attn_mlp=80-40, mlp=200-80, interaction=target-attn.

Target attention: for target item q and history key k_t the weight is
MLP([q, k_t, q-k_t, q*k_t]) (sigmoid hidden layers); the pool is the
weighted sum WITHOUT softmax normalisation.  Both ``attention_pool`` and
``score`` run it through the ``target_attention`` kernel; ``score``
hands the kernel per-user keys and (B, N) candidates, so the history is
never broadcast over the candidates.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.flops import dense_flops, mlp_flops
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclass(frozen=True)
class DINConfig:
    item_vocab: int = 200_000
    cat_vocab: int = 5_000
    user_vocab: int = 200_000
    n_user_fields: int = 2
    embed_dim: int = 18
    seq_len: int = 100
    attn_hidden: tuple = (80, 40)
    mlp_hidden: tuple = (200, 80)

    @property
    def d_item(self) -> int:  # id-emb ++ cat-emb
        return 2 * self.embed_dim


def init(gen: torch.Generator, cfg: DINConfig, device=None) -> dict:
    d = cfg.d_item
    d_mlp_in = cfg.n_user_fields * cfg.embed_dim + 2 * d
    return L.to_device({
        "item_emb": L.embedding_init(gen, cfg.item_vocab, cfg.embed_dim),
        "cat_emb": L.embedding_init(gen, cfg.cat_vocab, cfg.embed_dim),
        "user_emb": L.embedding_init(gen, cfg.user_vocab, cfg.embed_dim),
        "attn": L.mlp_init(gen, [4 * d, *cfg.attn_hidden, 1]),
        "mlp": L.mlp_init(gen, [d_mlp_in, *cfg.mlp_hidden, 1]),
        "prelu1": L.prelu_init(cfg.mlp_hidden[0]),
        "prelu2": L.prelu_init(cfg.mlp_hidden[1]),
    }, device or "cpu")


def embed_items(params, ids, cats):
    return torch.cat([L.embedding_apply(params["item_emb"], ids),
                      L.embedding_apply(params["cat_emb"], cats)], dim=-1)


def embed_candidates(params, cand_ids, cand_cats):
    """(B, N) candidates -> (B, N, d); a list shared by every user
    (batch stride 0) is embedded once and returned as a view."""
    if cand_ids.stride(0) == 0 and cand_cats.stride(0) == 0:
        one = embed_items(params, cand_ids[0], cand_cats[0])
        return one[None].expand(cand_ids.shape[0], *one.shape)
    return embed_items(params, cand_ids, cand_cats)


def _attn_weights(params) -> tuple:
    lay = params["attn"]["layers"]
    return (lay[0]["w"], lay[0]["b"], lay[1]["w"], lay[1]["b"],
            lay[2]["w"], lay[2]["b"])


def attention_pool(params, query, keys, mask):
    """query (B, d), keys (B, T, d), mask (B, T) -> pooled (B, d)."""
    return ops.target_attention(query[:, None, :], keys, mask,
                                *_attn_weights(params))[:, 0]


def _head(params, profile, pooled, target):
    x = torch.cat([profile, pooled, target], dim=-1)
    x = L.dense_apply(params["mlp"]["layers"][0], x)
    x = L.prelu_apply(params["prelu1"], x)
    x = L.dense_apply(params["mlp"]["layers"][1], x)
    x = L.prelu_apply(params["prelu2"], x)
    return L.dense_apply(params["mlp"]["layers"][2], x)[..., 0]


def _profile(params, user_fields):
    prof = L.embedding_apply(params["user_emb"], user_fields)
    return prof.reshape(*prof.shape[:-2], -1)


def forward(params, cfg: DINConfig, batch: dict):
    """Pointwise CTR logit. batch: hist_ids/hist_cats/hist_mask (B,T),
    user_fields (B,F), item_id/item_cat (B,) -> (B,) logits."""
    keys = embed_items(params, batch["hist_ids"], batch["hist_cats"])
    q = embed_items(params, batch["item_id"], batch["item_cat"])
    pooled = attention_pool(params, q, keys, batch["hist_mask"])
    return _head(params, _profile(params, batch["user_fields"]), pooled, q)


def score(params, cfg: DINConfig, batch: dict, cand_ids, cand_cats):
    """Rank N candidates per request: cand_ids/cand_cats (B, N) -> (B, N).

    ``cand_ids``/``cand_cats`` may be ``expand``-ed views of one shared
    candidate list; the kernel then reads it with batch stride 0."""
    keys = embed_items(params, batch["hist_ids"], batch["hist_cats"])
    q = embed_candidates(params, cand_ids, cand_cats)  # (B, N, d)
    pooled = ops.target_attention(q, keys, batch["hist_mask"],
                                  *_attn_weights(params))
    prof = _profile(params, batch["user_fields"])
    prof = prof[:, None, :].expand(*q.shape[:-1], prof.shape[-1])
    return _head(params, prof, pooled, q)


def loss_fn(params, cfg: DINConfig, batch: dict):
    """Mean BCE of ``forward``'s logits against ``batch["label"]``; its
    gradient runs the ``target_attention`` kernel's backward."""
    return L.sigmoid_bce(forward(params, cfg, batch), batch["label"])


def score_candidates_chunked(params, cfg: DINConfig, batch: dict, cand_ids,
                             cand_cats, *, n_chunks: int = 16):
    """retrieval_cand: ONE request (a batch of 1) against N candidates,
    cand_ids/cand_cats (N,) -> (N,) scores, in ``n_chunks`` equal chunks
    (N must divide by it).  Each chunk is one kernel call with the
    chunk's candidates as the user's N."""
    n = cand_ids.shape[0]
    if n % n_chunks:
        raise ValueError(f"{n} candidates do not divide into {n_chunks} "
                         f"chunks")
    c = n // n_chunks
    return torch.cat([score(params, cfg, batch, cand_ids[None, i:i + c],
                            cand_cats[None, i:i + c])[0]
                      for i in range(0, n, c)])


def flops_per_item(cfg: DINConfig) -> float:
    """Score one candidate for one user (paper Table 1 grain)."""
    d = cfg.d_item
    attn = cfg.seq_len * (mlp_flops([4 * d, *cfg.attn_hidden, 1]) + 4 * d)
    pool = dense_flops(cfg.seq_len, 1, use_bias=False) * d
    d_mlp_in = cfg.n_user_fields * cfg.embed_dim + 2 * d
    head = mlp_flops([d_mlp_in, *cfg.mlp_hidden, 1])
    return attn + pool + head
