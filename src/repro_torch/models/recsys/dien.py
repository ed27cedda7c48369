"""DIEN - Deep Interest Evolution Network (Zhou et al., AAAI'19).

The cascade's second rank model.  Interest extractor: a GRU over the
behaviour sequence, once per user.  Interest evolution: an AUGRU whose
update gate is scaled by the softmax attention of the target item,
once per (user, candidate).  Plain torch: the JAX package has no kernel
here.  ``score`` runs every (user, candidate) sequence of a block as one
batch of B*N rows - the Python loop is over time steps only - and
projects the user's GRU states through the AUGRU input weights once per
user instead of once per candidate.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.flops import gru_flops, mlp_flops
from repro_torch.models import layers as L
from repro_torch.models.recsys.din import embed_candidates, embed_items


@dataclass(frozen=True)
class DIENConfig:
    item_vocab: int = 200_000
    cat_vocab: int = 5_000
    user_vocab: int = 200_000
    n_user_fields: int = 2
    embed_dim: int = 18
    seq_len: int = 100
    attn_hidden: tuple = (80, 40)
    mlp_hidden: tuple = (200, 80)

    @property
    def d_item(self) -> int:
        return 2 * self.embed_dim


def _gru_init(gen, d_in, d_h):
    def gate():
        return {"wx": L.glorot_uniform(gen, (d_in, d_h)),
                "wh": L.glorot_uniform(gen, (d_h, d_h)),
                "b": torch.zeros(d_h)}
    return {"r": gate(), "z": gate(), "h": gate()}


def init(gen: torch.Generator, cfg: DIENConfig, device=None) -> dict:
    d = cfg.d_item
    d_mlp_in = cfg.n_user_fields * cfg.embed_dim + 2 * d
    return L.to_device({
        "item_emb": L.embedding_init(gen, cfg.item_vocab, cfg.embed_dim),
        "cat_emb": L.embedding_init(gen, cfg.cat_vocab, cfg.embed_dim),
        "user_emb": L.embedding_init(gen, cfg.user_vocab, cfg.embed_dim),
        "gru1": _gru_init(gen, d, d),
        "augru": _gru_init(gen, d, d),
        "attn": L.mlp_init(gen, [4 * d, *cfg.attn_hidden, 1]),
        "mlp": L.mlp_init(gen, [d_mlp_in, *cfg.mlp_hidden, 1]),
    }, device or "cpu")


def _gru_step(p, h, xp, update_gate_scale=None):
    """One GRU cell step from precomputed input projections ``xp`` =
    (x @ wx_r, x @ wx_z, x @ wx_h)."""
    xr, xz, xh = xp
    r = torch.sigmoid(xr + h @ p["r"]["wh"] + p["r"]["b"])
    z = torch.sigmoid(xz + h @ p["z"]["wh"] + p["z"]["b"])
    hh = torch.tanh(xh + (r * h) @ p["h"]["wh"] + p["h"]["b"])
    if update_gate_scale is not None:  # AUGRU: a_t scales the update gate
        z = z * update_gate_scale[..., None]
    return (1.0 - z) * h + z * hh


def _project(p, xs):
    """Input projections of a whole sequence (..., T, d) per gate."""
    return tuple(xs @ p[g]["wx"] for g in ("r", "z", "h"))


def _run_gru(p, xs, mask):
    """xs (B, T, d), mask (B, T) -> states (B, T, d)."""
    xp = _project(p, xs)
    h = torch.zeros(xs.shape[0], xs.shape[2], dtype=xs.dtype,
                    device=xs.device)
    out = []
    for t in range(xs.shape[1]):
        h_new = _gru_step(p, h, tuple(x[:, t] for x in xp))
        h = torch.where(mask[:, t, None] > 0, h_new, h)
        out.append(h)
    return torch.stack(out, dim=1)


def _run_augru(p, states, mask, attn_w):
    """AUGRU over per-user states (B, T, d) for (B, N) candidates whose
    attention is attn_w (B, N, T) -> final state (B, N, d)."""
    b, n, t_n = attn_w.shape
    xp = _project(p, states)  # once per user, shared by its candidates
    h = torch.zeros(b, n, states.shape[2], dtype=states.dtype,
                    device=states.device)
    for t in range(t_n):
        x_t = tuple(x[:, None, t, :] for x in xp)  # (B, 1, d)
        h_new = _gru_step(p, h, x_t, update_gate_scale=attn_w[:, :, t])
        h = torch.where(mask[:, None, t, None] > 0, h_new, h)
    return h


def _attention_weights(params, query, states, mask):
    """query (B, N, d), states (B, T, d), mask (B, T) -> (B, N, T)."""
    b, n, d = query.shape
    t = states.shape[1]
    q = query[:, :, None, :].expand(b, n, t, d)
    s = states[:, None, :, :].expand(b, n, t, d)
    feat = torch.cat([q, s, q - s, q * s], dim=-1)
    logits = L.mlp_apply(params["attn"], feat, act="sigmoid")[..., 0]
    m = mask[:, None, :]
    logits = torch.where(m > 0, logits, torch.full((), -1e9,
                                                   device=logits.device))
    return torch.softmax(logits, dim=-1) * (m.sum(-1, keepdim=True) > 0)


def forward(params, cfg: DIENConfig, batch: dict):
    """Pointwise CTR logit; same batch schema as DIN."""
    ids = batch["item_id"][:, None]
    cats = batch["item_cat"][:, None]
    return score(params, cfg, batch, ids, cats)[:, 0]


def score(params, cfg: DIENConfig, batch: dict, cand_ids, cand_cats):
    """(B, N) candidates -> (B, N).  GRU1 runs once per user; the AUGRU
    runs once per (user, candidate), all B*N of them as one batch."""
    xs = embed_items(params, batch["hist_ids"], batch["hist_cats"])
    mask = batch["hist_mask"]
    states = _run_gru(params["gru1"], xs, mask)  # (B, T, d)
    prof = L.embedding_apply(params["user_emb"], batch["user_fields"])
    prof = prof.reshape(*prof.shape[:-2], -1)
    q = embed_candidates(params, cand_ids, cand_cats)  # (B, N, d)
    a = _attention_weights(params, q, states, mask)
    final = _run_augru(params["augru"], states, mask, a)
    prof = prof[:, None, :].expand(*q.shape[:-1], prof.shape[-1])
    x = torch.cat([prof, final, q], dim=-1)
    return L.mlp_apply(params["mlp"], x, act="relu")[..., 0]


def loss_fn(params, cfg: DIENConfig, batch: dict):
    """Mean BCE of ``forward``'s logits against ``batch["label"]``."""
    return L.sigmoid_bce(forward(params, cfg, batch), batch["label"])


def flops_per_item(cfg: DIENConfig) -> float:
    d = cfg.d_item
    gru1 = gru_flops(cfg.seq_len, d, d)  # amortizable but paper bills per item
    attn = cfg.seq_len * (mlp_flops([4 * d, *cfg.attn_hidden, 1]) + 4 * d)
    augru = gru_flops(cfg.seq_len, d, d)
    d_mlp_in = cfg.n_user_fields * cfg.embed_dim + 2 * d
    head = mlp_flops([d_mlp_in, *cfg.mlp_hidden, 1])
    return gru1 + attn + augru + head
