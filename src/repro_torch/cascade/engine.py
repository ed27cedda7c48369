"""Cascade execution on CompactPlan tables (paper §5.1 protocol).

Every chain truncates the candidate set along the SAME per-model
orderings; only the thresholds (n2, n3, e) and the rank model differ.
For the paper's 3-stage layout (single-model recall and prerank pools,
any rank pool) the chains group by (rank model, n2): the members of a
group share all stage-0/1 arithmetic and differ only in n3, and one
compact candidate list of length cap = min(max n2, max n3) per group
serves every chain.  A request then collapses to threshold arithmetic
on one cap-wide row - the ``cascade_truncate`` kernel.

  * ``_compact_group_tables``       - NumPy host builder of the (G, U,
    cap) tables (the parity oracle);
  * ``_compact_group_tables_torch`` - the same algorithm on device
    tensors, bitwise equal to it: the (-score, id) sort key packs into
    one int64 and a single stable ``torch.sort`` orders each row;
  * ``_revenue_compact``            - per-request revenue on the tables,
    through the truncation kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.action_chain import ActionChainSet
from repro_torch.kernels import ops
from repro_torch.models.recsys import dien, din, dssm, ydnn


@dataclass
class CascadeModels:
    """Stage models (parameter trees on one device) + their configs."""

    dssm_params: dict
    dssm_cfg: dssm.DSSMConfig
    ydnn_params: dict
    ydnn_cfg: ydnn.YDNNConfig
    din_params: dict
    din_cfg: din.DINConfig
    dien_params: dict
    dien_cfg: dien.DIENConfig


def _user_batch(world, users: np.ndarray, device, pad_to: int | None = None,
                *, out: dict | None = None, staging: dict | None = None
                ) -> dict:
    """Model feature batch for ``users`` of a world, on ``device``; rows
    past len(users) up to ``pad_to`` are zeros (a fixed chunk shape).

    With ``out`` (static device buffers of the padded shape, one per
    key) and ``staging`` (pinned host buffers of the same shapes), the
    rows are written into the staging buffers and copied into ``out``
    with ``non_blocking`` copies on the current stream: the caller keeps
    the staging buffers untouched until those copies have completed."""
    n = len(users)
    rows = n if pad_to is None else int(pad_to)
    fresh = {}
    for key, arr, dt in (
            ("user_fields", world.user_fields[users], np.int64),
            ("hist_ids", world.hist_ids[users], np.int64),
            ("hist_cats", world.item_cat[world.hist_ids[users]], np.int64),
            ("hist_mask", world.hist_mask[users], np.float32)):
        if out is None:
            buf = np.zeros((rows, *arr.shape[1:]), dt)
            buf[:n] = arr
            fresh[key] = torch.from_numpy(buf).to(device)
            continue
        host = staging[key].numpy()
        host[:n] = arr
        host[n:] = 0
        out[key].copy_(staging[key], non_blocking=True)
    return fresh if out is None else out


def _k3_layout(chains: ActionChainSet, *, n_items: int):
    """Compile the chain set for the 3-stage compact layout, or None.

    Applicable when recall and prerank have single-model pools; chains
    group by (rank model, effective n2) and differ inside a group only
    in their n3 threshold."""
    if chains.n_stages != 3:
        return None
    if chains.stages[0].n_models != 1 or chains.stages[1].n_models != 1:
        return None
    keep0 = np.minimum(chains.scale_value[:, 1],
                       np.minimum(chains.scale_value[:, 0],
                                  n_items)).astype(np.int64)
    n2_vals, n2_idx = np.unique(keep0, return_inverse=True)
    m_idx = chains.chain_idx[:, 2, 0].astype(np.int64)
    n3 = chains.scale_value[:, 2].astype(np.int64)
    groups = {}
    for j in range(chains.n_chains):
        groups.setdefault((int(m_idx[j]), int(n2_idx[j])), []).append(j)
    group_key = tuple(  # one (rank_model, n2, (n3, ...)) tuple per group
        (mi, int(n2_vals[n2i]), tuple(int(n3[j]) for j in js))
        for (mi, n2i), js in sorted(groups.items()))
    chain_order = np.asarray(
        [j for _, js in sorted(groups.items()) for j in js], np.int64)
    return {
        "group_key": group_key,
        "chain_order": chain_order,  # kernel row -> chain id
        "stage_names": (chains.stages[0].models[0].name,
                        chains.stages[1].models[0].name,
                        tuple(m.name for m in chains.stages[2].models)),
    }


# ---------------------------------------------------------------------------
# Table builders
# ---------------------------------------------------------------------------


def _desc_perm(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Indirect sort of the last axis by (-score, id) - the restriction
    of the global stable descending order to a candidate list.  float32
    scores pack (score, id) into one int64 key via an order-preserving
    bit map; other dtypes take np.lexsort."""
    if scores.dtype == np.float32:
        # gf: allow[GF006] host NumPy: the add runs eagerly, so -0.0
        # really becomes +0.0 (the device twin uses torch.where)
        s = scores + 0.0
        b = s.view(np.int32)
        mono = b ^ ((b >> 31) & np.int32(0x7FFFFFFF))  # float order -> int
        key = ((~mono).astype(np.int64) << 32) + ids
        return np.argsort(key, axis=-1, kind="stable")
    return np.lexsort((ids, -scores), axis=-1)


def _compact_group_tables(stage_scores: dict, lay: dict, clicks: np.ndarray,
                          *, order1: np.ndarray | None = None,
                          expose: int):
    """Decision-independent compaction tables for the k3 layout (host).

    ``p_sorted[g, u]`` lists, in the rank model's descending stable
    order over group g's compact candidate list, each entry's
    survivor-prefix position (sentinel ``cap`` for invalid tail slots)
    and ``clicks_sorted[g, u]`` the matching clicks.
    Returns (p_sorted (G, U, cap), clicks_sorted (G, U, cap), cap).
    """
    m0, m1, mr = lay["stage_names"]
    u_n, i_n = clicks.shape
    gk = lay["group_key"]
    n2_list = sorted({g[1] for g in gk})
    n2_pos = {n2: k for k, n2 in enumerate(n2_list)}
    n2_max = n2_list[-1]
    cap = min(n2_max, max(max(g[2]) for g in gk))
    cdt = np.int16 if i_n < 2 ** 15 else np.int32  # count dtype
    qdt = np.int8 if max(cap, expose) < 127 else cdt  # survivor counts
    rows_off = (np.arange(u_n, dtype=np.intp) * i_n)[:, None]

    if order1 is None:
        order1 = np.argsort(-np.asarray(stage_scores[m0]), axis=1,
                            kind="stable")

    # candidate universe: the top-n2_max recall items, ordered by the
    # prerank model ((-score, id) == the global stable order restricted)
    cands = order1[:, :n2_max].astype(np.int32)  # (U, C); stage-0 rank = c
    sy = np.take(np.asarray(stage_scores[m1]).ravel(), cands + rows_off)
    yperm = _desc_perm(sy, cands)  # (U, C)
    l_items = np.take_along_axis(cands, yperm, axis=1)
    r1_l = yperm.astype(cdt)  # stage-0 rank of entry == pre-perm column

    # per distinct n2 (batched): compact the first-cap stage-1 survivors
    s1 = r1_l[None, :, :] < np.asarray(n2_list, cdt)[:, None, None]
    q2 = np.cumsum(s1, axis=2, dtype=cdt) - s1  # exclusive survivor count
    slot = np.where(s1 & (q2 < cap), q2, cdt(cap))
    scat = np.full((len(n2_list), u_n, cap + 1), n2_max, cdt)
    np.put_along_axis(
        scat, slot,
        np.broadcast_to(np.arange(n2_max, dtype=cdt), slot.shape), axis=2)
    lpos = scat[:, :, :cap]  # positions into the prerank-ordered list
    lvalid = lpos < n2_max
    lpos_c = np.minimum(lpos, cdt(n2_max - 1))

    # per group = (rank model, n2): order each compact list by the rank
    # model ((-score, id) again); invalid tail slots sink via -inf
    n2_of_g = np.asarray([n2_pos[n2] for _, n2, _ in gk], np.intp)
    m_of_g = np.asarray([mi for mi, _, _ in gk], np.intp)
    g_items = np.take_along_axis(l_items[None], lpos_c, axis=2)[n2_of_g]
    g_valid = lvalid[n2_of_g]
    scores_r = np.stack([np.asarray(stage_scores[n]) for n in mr])
    g_scores = np.take(scores_r.ravel(),
                       g_items + ((m_of_g * (u_n * i_n))[:, None, None]
                                  + rows_off[None]))
    g_scores[~g_valid] = -np.inf  # invalid tail slots sort last
    mperm = _desc_perm(g_scores, g_items)  # (G, U, cap)
    p_sorted = np.where(np.take_along_axis(g_valid, mperm, axis=2),
                        mperm.astype(qdt), qdt(cap))
    g_clicks = np.take(clicks.ravel(), g_items + rows_off[None]) * g_valid
    clicks_sorted = np.take_along_axis(g_clicks, mperm, axis=2)
    return p_sorted, clicks_sorted, cap


def _desc_perm_torch(scores, ids):
    """Device twin of ``_desc_perm`` for float32 scores: the same int64
    (-score, id) key, one stable sort - bitwise the host order."""
    s = torch.where(scores == 0.0, torch.zeros((), device=scores.device),
                    scores)  # canonicalize -0.0 to +0.0
    b = s.contiguous().view(torch.int32)
    mono = b ^ ((b >> 31) & 0x7FFFFFFF)  # float order -> int order
    key = ((~mono).to(torch.int64) << 32) + ids.to(torch.int64)
    return torch.sort(key, dim=-1, stable=True).indices


def compact_index(lay: dict, device) -> dict:
    """The k3 layout's index vectors for ``_compact_group_tables_torch``
    as tensors on ``device``: the distinct n2 thresholds, each group's n2
    position and rank model.  Made once with the layout, so the builder
    copies nothing from the host (a CUDA graph can capture it)."""
    gk = lay["group_key"]
    n2_list = sorted({g[1] for g in gk})
    n2_pos = {n2: k for k, n2 in enumerate(n2_list)}
    return {k: torch.as_tensor(np.asarray(v, np.int64), device=device)
            for k, v in (("n2", n2_list),
                         ("n2_of_g", [n2_pos[n2] for _, n2, _ in gk]),
                         ("m_of_g", [mi for mi, _, _ in gk]))}


def _compact_group_tables_torch(stage_scores: dict, lay: dict, clicks,
                                index: dict | None = None):
    """``_compact_group_tables`` on device tensors.

    Every step is row (user) independent, so a padded scoring chunk
    compacts at the fixed chunk shape and is sliced to the real rows
    afterwards.  Scores must be float32.  ``index`` is
    ``compact_index(lay, device)`` (made here when None).  Returns
    (p_sorted (G, U, cap) int32, clicks_sorted (G, U, cap) float32),
    bitwise equal to the host builder."""
    m0, m1, mr = lay["stage_names"]
    u_n, i_n = clicks.shape
    dev = clicks.device
    gk = lay["group_key"]
    n2_list = sorted({g[1] for g in gk})
    n2_max = n2_list[-1]
    cap = min(n2_max, max(max(g[2]) for g in gk))
    if index is None:
        index = compact_index(lay, dev)

    s0 = stage_scores[m0]
    if s0.dtype != torch.float32:
        raise ValueError("the device table builder needs float32 scores")
    ids_full = torch.arange(i_n, device=dev).expand(u_n, i_n)
    cands = _desc_perm_torch(s0, ids_full)[:, :n2_max]  # (U, C)
    sy = torch.gather(stage_scores[m1], 1, cands)
    yperm = _desc_perm_torch(sy, cands)  # (U, C)
    l_items = torch.gather(cands, 1, yperm)

    # per distinct n2 (batched): compact the first-cap stage-1 survivors
    k2 = len(n2_list)
    s1 = yperm[None, :, :] < index["n2"][:, None, None]
    s1_i = s1.to(torch.int64)
    q2 = torch.cumsum(s1_i, dim=2) - s1_i  # exclusive survivor count
    slot = torch.where(s1 & (q2 < cap), q2, torch.full_like(q2, cap))
    scat = torch.full((k2, u_n, cap + 1), n2_max, dtype=torch.int64,
                      device=dev)
    vals = torch.arange(n2_max, device=dev).expand(k2, u_n, n2_max)
    # collisions only ever land on the dropped sentinel column ``cap``
    scat.scatter_(2, slot, vals)
    lpos = scat[:, :, :cap]
    lvalid = lpos < n2_max
    lpos_c = torch.clamp(lpos, max=n2_max - 1)

    # per group = (rank model, n2): rank-model (-score, id) order
    n2_of_g, m_of_g = index["n2_of_g"], index["m_of_g"]
    g_items = torch.gather(l_items[None].expand(k2, u_n, n2_max), 2,
                           lpos_c)[n2_of_g]  # (G, U, cap)
    g_valid = lvalid[n2_of_g]
    scores_r = torch.stack([stage_scores[nm] for nm in mr])  # (M, U, I)
    flat = (m_of_g[:, None, None] * (u_n * i_n)
            + torch.arange(u_n, device=dev)[None, :, None] * i_n + g_items)
    g_scores = torch.take(scores_r, flat)
    g_scores = torch.where(g_valid, g_scores,
                           torch.full((), -torch.inf, device=dev))
    mperm = _desc_perm_torch(g_scores, g_items)  # (G, U, cap)
    p_sorted = torch.where(torch.gather(g_valid, 2, mperm), mperm,
                           torch.full_like(mperm, cap)).to(torch.int32)
    g_n = len(gk)
    g_clicks = torch.gather(clicks[None].expand(g_n, u_n, i_n), 2,
                            g_items) * g_valid
    clicks_sorted = torch.gather(g_clicks, 2, mperm)
    return p_sorted, clicks_sorted.to(torch.float32)


# ---------------------------------------------------------------------------
# Serving tables and execution
# ---------------------------------------------------------------------------


@dataclass
class CompactPlan:
    """Decision-independent serving tables for the k3 cascade layout:
    gather ``p_sorted[group, user]`` and ``clicks_sorted[group, user]``,
    keep positions < n3, expose the first ``expose`` survivors."""

    p_sorted: np.ndarray  # (G, U, cap) int32, sentinel cap = invalid
    clicks_sorted: np.ndarray  # (G, U, cap) float32
    group_of_chain: np.ndarray  # (J,) int32
    n3_of_chain: np.ndarray  # (J,) int32, min(n3, cap)
    cap: int
    expose: int


def _layout_cap(gk: tuple) -> int:
    """Compact-row width for a k3 group key: min(max n2, max n3)."""
    n2_max = max(g[1] for g in gk)
    return min(n2_max, max(max(g[2]) for g in gk))


def _layout_chain_maps(lay: dict, n_chains: int,
                       cap: int) -> tuple[np.ndarray, np.ndarray]:
    """(group_of_chain, n3_of_chain) int32 vectors from a k3 layout."""
    g_of = np.empty(n_chains, np.int32)
    n3_of = np.empty(n_chains, np.int32)
    pos = 0
    for g, (_, _, n3list) in enumerate(lay["group_key"]):
        for n3 in n3list:
            j = int(lay["chain_order"][pos])
            g_of[j] = g
            n3_of[j] = min(int(n3), cap)
            pos += 1
    return g_of, n3_of


def build_compact_layout(chains: ActionChainSet, *, n_items: int,
                         expose: int) -> CompactPlan | None:
    """The user-independent part of a CompactPlan (or None off the k3
    layout): group/threshold maps and the row width, with EMPTY
    per-user tables - what a streaming source serves against."""
    lay = _k3_layout(chains, n_items=n_items)
    if lay is None:
        return None
    cap = _layout_cap(lay["group_key"])
    g_of, n3_of = _layout_chain_maps(lay, chains.n_chains, cap)
    g_n = len(lay["group_key"])
    return CompactPlan(np.full((g_n, 1, cap), cap, np.int32),
                       np.zeros((g_n, 1, cap), np.float32), g_of, n3_of,
                       int(cap), int(expose))


def _revenue_compact(p_sorted, clicks_sorted, groups, rows, n3, *,
                     expose: int):
    """Per-request revenue on CompactPlan tables: request b reads row
    (groups[b], rows[b]) and keeps survivor positions < n3[b], exposing
    the first ``expose`` - the ``cascade_truncate`` kernel on the card,
    its plain version on the CPU."""
    return ops.cascade_truncate(p_sorted, clicks_sorted, groups, rows, n3,
                                expose=expose)
