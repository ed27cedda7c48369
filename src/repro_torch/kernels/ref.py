"""Plain-torch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, in ordinary
torch ops.  On the CPU the wrappers in ``kernels.ops`` run these; on
the card ``chip_smoke.py`` and the GPU tests hold every kernel against
them on the same inputs.  They repeat the kernels' arithmetic and are
no yardstick of speed.
"""
from __future__ import annotations

import math

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


def dot_interact_ref(feats):
    """DLRM dot interaction: feats (B, F, D) -> (B, F(F-1)/2), the
    strictly lower triangle of each sample's Gram matrix in the order of
    ``np.tril_indices(F, k=-1)``, summed in f32 and returned in the
    input's dtype."""
    f = feats.shape[1]
    x = feats.float()
    z = torch.bmm(x, x.mT)  # (B, F, F)
    iu, ju = torch.tril_indices(f, f, offset=-1, device=feats.device)
    return z[:, iu, ju].to(feats.dtype)


def cin_layer_ref(w, x_prev, x0, *, chunk_elems: int = 1 << 26):
    """xDeepFM CIN layer: w (H_out, Hp*m), x_prev (B, Hp, D), x0 (B, m, D)
    -> (B, H_out, D), out[b,o,d] = sum_{h,j} w[o, h*m+j] x_prev[b,h,d]
    x0[b,j,d].  Z = x_prev (x) x0 is formed for ``chunk_elems`` floats'
    worth of samples at a time (Z is Hp*m*D floats a sample: 312 KB at
    the published widths, 82 GB for a 262,144 batch whole)."""
    b, hp, d = x_prev.shape
    m = x0.shape[1]
    step = max(1, chunk_elems // max(1, hp * m * d))
    outs = [x_prev.new_empty((0, w.shape[0], d))]
    for s in range(0, b, step):
        xp, xz = x_prev[s:s + step], x0[s:s + step]
        z = torch.einsum("bhd,bmd->bhmd", xp, xz).reshape(-1, hp * m, d)
        outs.append(torch.einsum("oc,bcd->bod", w, z))
    return torch.cat(outs)


def flash_attention_ref(q, k, v, *, causal=True, window=-1, softcap=None,
                        scale=None):
    """q (B, T, H, dh), k/v (B, S, Hkv, dh) -> (B, T, H, dh), kv head
    h // (H / Hkv).  The logits come out of an einsum in the inputs' dtype
    and are then cast to f32, scaled and soft-capped; the masks count
    positions from 0 (causal ``k_pos <= q_pos``, window ``q_pos - k_pos <
    window`` when ``window > 0``); the f32 softmax is cast to v's dtype
    before the second einsum.  The (B, Hkv, G, T, S) logits are formed
    whole: 2.1 GB in f32 at T = S = 8,192 and 8 heads."""
    b, t, h, dh = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, t, hk, g, dh)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(b, t, h, dh)


def target_attention_bwd_ref(dout, q, keys, mask, w1, b1, w2, b2, w3, b3):
    """The backward of ``target_attention_ref``: dout (B, N, d) -> dq
    (B, N, d), dkeys (B, T, d) and the MLP's dW1, db1, dW2, db2, dW3, db3,
    each shaped like its input.  The forward is recomputed and the chain
    rule written out, as the kernel does; the (B, N, T, 4d) features are
    formed whole (3.8 GB at DIN's train_batch, B = 65,536, T = 100)."""
    b, n, d = q.shape
    t = keys.shape[1]
    qb = q[:, :, None, :].expand(b, n, t, d)
    kb = keys[:, None, :, :].expand(b, n, t, d)
    feat = torch.cat([qb, kb, qb - kb, qb * kb], dim=-1)
    a1 = torch.sigmoid(feat @ w1 + b1)
    a2 = torch.sigmoid(a1 @ w2 + b2)
    w = (a2 @ w3 + b3)[..., 0]  # (B, N, T)
    m = mask[:, None, :]
    ds = m * torch.einsum("bnd,btd->bnt", dout, keys)
    dz2 = ds[..., None] * w3[:, 0] * a2 * (1 - a2)
    dz1 = (dz2 @ w2.T) * a1 * (1 - a1)
    f0, f1, f2, f3 = (dz1 @ w1.T).split(d, dim=-1)
    dq = (f0 + f2 + kb * f3).sum(dim=2)
    dk = (torch.einsum("bnt,bnd->btd", w * m, dout)
          + (f1 - f2 + qb * f3).sum(dim=1))
    h1, h2 = w1.shape[1], w2.shape[1]
    dw1 = feat.reshape(-1, 4 * d).T @ dz1.reshape(-1, h1)
    dw2 = a1.reshape(-1, h1).T @ dz2.reshape(-1, h2)
    dw3 = (a2 * ds[..., None]).reshape(-1, h2).sum(dim=0)
    return (dq, dk, dw1, dz1.reshape(-1, h1).sum(dim=0).reshape(b1.shape),
            dw2, dz2.reshape(-1, h2).sum(dim=0).reshape(b2.shape),
            dw3.reshape(w3.shape), ds.sum().reshape(b3.shape))


def embedding_bag_bwd_ref(dout, ids, weights, num_rows: int):
    """The backward of ``embedding_bag_ref`` into the table: dout (B, D),
    ids (B, L), weights (B, L) or None -> the dense (num_rows, D)
    gradient, dtable[v] = sum over ids[b, l] = v of w[b, l] dout[b]."""
    d = dout.shape[1]
    g = dout[:, None, :].expand(-1, ids.shape[1], -1)
    if weights is not None:
        g = g * weights[..., None]
    out = dout.new_zeros((num_rows, d))
    return out.index_add_(0, ids.reshape(-1).long(), g.reshape(-1, d))


def dot_interact_bwd_ref(dout, feats):
    """The backward of ``dot_interact_ref``: dout (B, F(F-1)/2) -> dfeats
    (B, F, D) in feats' dtype.  Per sample, G (F, F) holds dout in its
    strictly lower triangle (``np.tril_indices(F, k=-1)`` order) and
    dfeats = (G + G^T) X, summed in f32."""
    b, f, _ = feats.shape
    iu, ju = torch.tril_indices(f, f, offset=-1, device=feats.device)
    g = torch.zeros((b, f, f), dtype=torch.float32, device=feats.device)
    g[:, iu, ju] = dout.float()
    return torch.bmm(g + g.mT, feats.float()).to(feats.dtype)


def cin_layer_bwd_ref(dz, w, x_prev, x0, *, chunk_elems: int = 1 << 26):
    """The backward of ``cin_layer_ref``: dz (B, H_out, D) -> (dw (H_out,
    Hp*m), dx_prev (B, Hp, D), dx0 (B, m, D)).  With Z = x_prev (x) x0
    and T = w^T dz, both (B, Hp*m, D):

        dw = sum_{b,d} dz (x) Z,
        dx_prev[b,h,d] = sum_j x0[b,j,d] T[b,hm+j,d],
        dx0[b,j,d] = sum_h x_prev[b,h,d] T[b,hm+j,d].

    Z and T are formed ``chunk_elems`` floats' worth of samples at a time
    (each is 20.4 GB whole at xDeepFM's train_batch), dw summed over the
    chunks in order."""
    b, hp, d = x_prev.shape
    m = x0.shape[1]
    step = max(1, chunk_elems // max(1, hp * m * d))
    dw = torch.zeros_like(w)
    dxp, dx0 = [x_prev.new_empty((0, hp, d))], [x0.new_empty((0, m, d))]
    for s in range(0, b, step):
        xp, xz, g = x_prev[s:s + step], x0[s:s + step], dz[s:s + step]
        z = torch.einsum("bhd,bmd->bhmd", xp, xz).reshape(-1, hp * m, d)
        dw += torch.einsum("bod,bcd->oc", g, z)
        t = torch.einsum("oc,bod->bcd", w, g).reshape(-1, hp, m, d)
        dxp.append(torch.einsum("bhmd,bmd->bhd", t, xz))
        dx0.append(torch.einsum("bhmd,bhd->bmd", t, xp))
    return dw, torch.cat(dxp), torch.cat(dx0)


def flash_attention_bwd_ref(dout, q, k, v, out, *, causal=True, window=-1,
                            softcap=None, scale=None):
    """The backward of ``flash_attention_ref``: dout and the forward's
    output ``out`` (B, T, H, dh) -> (dq, dk, dv) shaped and typed like q,
    k and v.  Computed in f32 from the upcast inputs, as the kernel does:
    P = exp(s - lse) from the recomputed logits s, dP = dO V^T, dS = P (dP
    - D) with D = rowsum(dO o O), times the softcap's 1 - tanh^2 and the
    scale; dq = dS K, dk = dS^T Q, dv = P^T dO, each query head adding
    into its kv head.  Masked (query, key) pairs weigh 0.  A query row
    that admits no key is refused by ``ops.flash_attention_bwd``; the
    (B, Hkv, G, T, S) logits are formed whole."""
    b, t, h, dh = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, t, hk, g, dh)
    dog = dout.float().reshape(b, t, hk, g, dh)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale
    if softcap:
        th = torch.tanh(logits / softcap)
        logits = softcap * th
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - lse), 0.0)
    delta = (dout.float() * out.float()).sum(-1)  # (B, T, H)
    delta = delta.reshape(b, t, hk, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("btkgd,bskd->bkgts", dog, vf)
    ds = p * (dp - delta)
    if softcap:
        ds = ds * (1 - th * th)
    ds = ds * scale
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf).reshape(b, t, h, dh)
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qg)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
