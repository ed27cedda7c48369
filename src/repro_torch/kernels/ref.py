"""Plain-torch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, in ordinary
torch ops.  On the CPU the wrappers in ``kernels.ops`` run these; on
the card ``chip_smoke.py`` and the GPU tests hold every kernel against
them on the same inputs.  They repeat the kernels' arithmetic and are
no yardstick of speed.
"""
from __future__ import annotations

import torch


def cascade_truncate_ref(p_sorted, clicks_sorted, groups, rows, n3, *,
                         expose: int):
    """Revenue@expose per request from CompactPlan tables.

    p_sorted (G, U, C) int (sentinel >= cap for invalid slots),
    clicks_sorted (G, U, C) f32, groups/rows/n3 (B,) int -> (B,) f32.
    Request b reads row (groups[b], rows[b]), keeps survivor positions
    < n3[b] and exposes the first ``expose`` of them.
    """
    g = groups.long()
    r = rows.long()
    p = p_sorted[g, r]  # (B, C)
    ck = clicks_sorted[g, r]
    m = p < n3[:, None]
    q = torch.cumsum(m.to(torch.int32), dim=1)  # inclusive
    m = m & (q <= expose)
    return torch.where(m, ck, torch.zeros((), dtype=ck.dtype,
                                          device=ck.device)).sum(dim=1)


def target_attention_ref(q, keys, mask, w1, b1, w2, b2, w3, b3):
    """DIN target attention, candidate form.

    q (B, N, d) candidates, keys (B, T, d) and mask (B, T) per user;
    the attention MLP is [q, k, q-k, q*k] (4d) -> sigmoid(W1) ->
    sigmoid(W2) -> W3, its output times the mask weighting an
    UNNORMALISED sum of the keys -> (B, N, d).
    """
    b, n, d = q.shape
    t = keys.shape[1]
    qb = q[:, :, None, :].expand(b, n, t, d)
    kb = keys[:, None, :, :].expand(b, n, t, d)
    feat = torch.cat([qb, kb, qb - kb, qb * kb], dim=-1)
    h = torch.sigmoid(feat @ w1 + b1)
    h = torch.sigmoid(h @ w2 + b2)
    w = (h @ w3 + b3)[..., 0]  # (B, N, T)
    w = w * mask[:, None, :]
    return torch.einsum("bnt,btd->bnd", w, keys)


def embedding_bag_ref(table, ids, weights=None):
    """table (V, D), ids (B, L), weights (B, L) or None -> (B, D)."""
    rows = table[ids.long()]  # (B, L, D)
    if weights is not None:
        rows = rows * weights[..., None]
    return rows.sum(dim=1)
