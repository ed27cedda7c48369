"""BST - Behavior Sequence Transformer (Chen et al. [arXiv:1905.06874]).

Published config: embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
mlp=1024-512-256, interaction=transformer-seq.

The behavior sequence (19 history items + the target item appended, each
with a learned position embedding) runs through one post-LN transformer
block; the flattened sequence output concats with profile features into
the 1024-512-256 MLP head (LeakyReLU, slope 0.01, per the paper).

The attention is written out as matmuls and a softmax, as in the JAX
package, where it runs outside any Pallas kernel (T = 20, d_head = 8):
there is no kernel on this model's path.  Masked scores are -1e9, not
-inf, and the sequence is multiplied by its mask before the flatten.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.flops import attention_flops, dense_flops, mlp_flops
from repro_torch.models import layers as L


@dataclass(frozen=True)
class BSTConfig:
    item_vocab: int = 4_000_000
    cat_vocab: int = 100_000
    user_vocab: int = 1_000_000
    n_user_fields: int = 4
    embed_dim: int = 32
    seq_len: int = 20  # includes the target item slot
    n_blocks: int = 1
    n_heads: int = 8
    d_ff_mult: int = 4
    mlp_hidden: tuple = (1024, 512, 256)

    @property
    def d_item(self) -> int:  # id ++ cat
        return 2 * self.embed_dim

    @property
    def d_head(self) -> int:
        return self.d_item // self.n_heads


def _block_init(gen, cfg: BSTConfig) -> dict:
    d = cfg.d_item
    return {
        "wq": L.glorot_uniform(gen, (d, d)),
        "wk": L.glorot_uniform(gen, (d, d)),
        "wv": L.glorot_uniform(gen, (d, d)),
        "wo": L.glorot_uniform(gen, (d, d)),
        "ln1": L.layernorm_init(d),
        "ln2": L.layernorm_init(d),
        "ffn": L.mlp_init(gen, [d, cfg.d_ff_mult * d, d]),
    }


def init(gen: torch.Generator, cfg: BSTConfig, device=None) -> dict:
    d_mlp_in = cfg.n_user_fields * cfg.embed_dim + cfg.seq_len * cfg.d_item
    return L.to_device({
        "item_emb": L.embedding_init(gen, cfg.item_vocab, cfg.embed_dim),
        "cat_emb": L.embedding_init(gen, cfg.cat_vocab, cfg.embed_dim),
        "user_emb": L.embedding_init(gen, cfg.user_vocab, cfg.embed_dim),
        "pos_emb": L.normal_init(gen, (cfg.seq_len, cfg.d_item)),
        "blocks": [_block_init(gen, cfg) for _ in range(cfg.n_blocks)],
        "mlp": L.mlp_init(gen, [d_mlp_in, *cfg.mlp_hidden, 1]),
    }, device or "cpu")


def _leaky(z):
    return torch.where(z >= 0, z, 0.01 * z)


def _mha(p, cfg: BSTConfig, x, mask):
    """x (..., T, d), mask (..., T)."""
    lead, h, dh = x.shape[:-1], cfg.n_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(*lead, h, dh)
    k = (x @ p["wk"]).reshape(*lead, h, dh)
    v = (x @ p["wv"]).reshape(*lead, h, dh)
    s = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(dh)
    s = torch.where(mask[..., None, None, :] > 0, s,
                    torch.tensor(-1e9, dtype=s.dtype, device=s.device))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("...hqk,...khd->...qhd", a, v).reshape(*lead,
                                                            cfg.d_item)
    return o @ p["wo"]


def _block(p, cfg: BSTConfig, x, mask):
    # post-LN, per the BST paper
    x = L.layernorm_apply(p["ln1"], x + _mha(p, cfg, x, mask))
    h = _leaky(L.dense_apply(p["ffn"]["layers"][0], x))
    h = L.dense_apply(p["ffn"]["layers"][1], h)
    return L.layernorm_apply(p["ln2"], x + h)


def embed_seq(params, ids, cats):
    return torch.cat([L.embedding_apply(params["item_emb"], ids),
                      L.embedding_apply(params["cat_emb"], cats)], dim=-1)


def forward(params, cfg: BSTConfig, batch: dict):
    """batch: hist_ids/hist_cats/hist_mask (B, T-1), item_id/item_cat (B,),
    user_fields (B, F) -> (B,) logits."""
    hist = embed_seq(params, batch["hist_ids"], batch["hist_cats"])
    target = embed_seq(params, batch["item_id"], batch["item_cat"])
    x = torch.cat([hist, target[..., None, :]], dim=-2)  # (B, T, d)
    hm = batch["hist_mask"]
    mask = torch.cat([hm, hm.new_ones((*hm.shape[:-1], 1))], dim=-1)
    x = x + params["pos_emb"]
    for blk in params["blocks"]:
        x = _block(blk, cfg, x, mask)
    x = x * mask[..., None]
    seq_flat = x.reshape(*x.shape[:-2], -1)
    prof = L.embedding_apply(params["user_emb"], batch["user_fields"])
    prof = prof.reshape(*prof.shape[:-2], -1)
    z = torch.cat([prof, seq_flat], dim=-1)
    layers = params["mlp"]["layers"]
    for i, layer in enumerate(layers):
        z = L.dense_apply(layer, z)
        if i < len(layers) - 1:
            z = _leaky(z)
    return z[..., 0]


USER_KEYS = ("hist_ids", "hist_cats", "hist_mask", "user_fields")


def score(params, cfg: BSTConfig, batch: dict, cand_ids, cand_cats):
    """(B, N) candidates -> (B, N) scores: one forward over the B N rows
    (the JAX package's vmap over candidates)."""
    b, n = cand_ids.shape
    rows = {k: batch[k][:, None].expand(b, n, *batch[k].shape[1:])
            .reshape(b * n, *batch[k].shape[1:]) for k in USER_KEYS}
    rows["item_id"] = cand_ids.reshape(-1)
    rows["item_cat"] = cand_cats.reshape(-1)
    return forward(params, cfg, rows).reshape(b, n)


def loss_fn(params, cfg: BSTConfig, batch: dict):
    return L.sigmoid_bce(forward(params, cfg, batch), batch["label"])


def flops_per_example(cfg: BSTConfig) -> float:
    d, t = cfg.d_item, cfg.seq_len
    proj = 4 * dense_flops(d, d, t)
    attn = attention_flops(t, t, cfg.n_heads, cfg.d_head)
    ffn = mlp_flops([d, cfg.d_ff_mult * d, d], t)
    block = (proj + attn + ffn) * cfg.n_blocks
    d_mlp_in = cfg.n_user_fields * cfg.embed_dim + t * d
    head = mlp_flops([d_mlp_in, *cfg.mlp_hidden, 1])
    return block + head


def score_candidates_chunked(params, cfg: BSTConfig, batch: dict,
                             cand_ids, cand_cats, *, n_chunks: int = 16):
    """retrieval_cand path: ONE request (row 0 of ``batch``) vs N
    candidates, ``n_chunks`` forwards of N / n_chunks rows."""
    n = cand_ids.shape[0]
    if n % n_chunks:
        raise ValueError(f"{n} candidates do not split into {n_chunks} "
                         f"chunks")
    c = n // n_chunks
    user = {k: batch[k][:1].expand(c, batch[k].shape[1]) for k in USER_KEYS}
    return torch.cat([
        forward(params, cfg, dict(user, item_id=cand_ids[i * c:(i + 1) * c],
                                  item_cat=cand_cats[i * c:(i + 1) * c]))
        for i in range(n_chunks)])
