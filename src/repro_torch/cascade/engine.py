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

The offline oracle rides on the same semantics: every stage keeps the
first ``keep`` surviving items along the stage model's descending
stable order (ties by item id).  ``run_chain`` and
``simulate_revenue_matrix_reference`` are the brute-force NumPy form,
``simulate_revenue_matrix`` the compaction form (bitwise equal to it),
``_revenue_all_chains`` and ``_revenue_requests`` the generic K-stage
form on tensors, and ``CascadeServer`` serves allocated chains over a
materialized user universe: through the ``cascade_truncate`` kernel on
its CompactPlan where the layout has one, through ``_revenue_requests``
where it has none.
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


STAGE_MODELS = ("DSSM", "YDNN", "DIN", "DIEN")


def corpus_items(models: CascadeModels, item_cats) -> tuple:
    """(item ids, item categories, DSSM item-tower vectors) of the whole
    corpus on the models' device: the item side every user batch is
    scored against."""
    dev = models.dssm_params["user_emb"]["table"].device
    cats = torch.as_tensor(np.asarray(item_cats), device=dev)
    ids = torch.arange(len(cats), device=dev)
    if models.dssm_cfg.n_item_fields == 1:
        fields = cats[:, None]
    else:
        fields = torch.stack([ids, cats], dim=-1)
    with torch.no_grad():
        return ids, cats, dssm.item_tower(models.dssm_params,
                                          models.dssm_cfg, fields)


@torch.no_grad()
def score_corpus(models: CascadeModels, name: str, ub: dict, items: tuple,
                 *, item_block: int):
    """(B, I) f32 scores of stage model ``name`` for a user batch ``ub``
    against the corpus ``items`` (``corpus_items``); DIN and DIEN score
    the candidates in blocks of ``item_block``."""
    item_ids, item_cats, dssm_items = items
    n_items = len(item_ids)
    if name == "DSSM":
        return dssm.user_tower(models.dssm_params, models.dssm_cfg,
                               ub["user_fields"]) @ dssm_items.T
    if name == "YDNN":
        return ydnn.user_vector(
            models.ydnn_params, models.ydnn_cfg, ub["hist_ids"],
            ub["hist_mask"], ub["user_fields"]) \
            @ models.ydnn_params["out_emb"]["table"][:n_items].T
    mod, params, cfg = {"DIN": (din, models.din_params, models.din_cfg),
                        "DIEN": (dien, models.dien_params,
                                 models.dien_cfg)}[name]
    c = ub["user_fields"].shape[0]
    cols = []
    for lo in range(0, n_items, item_block):
        hi = min(n_items, lo + item_block)
        ids = item_ids[lo:hi].expand(c, hi - lo)
        cats = item_cats[lo:hi].expand(c, hi - lo)
        cols.append(mod.score(params, cfg, ub, ids, cats))
    return torch.cat(cols, dim=1)


def precompute_stage_scores(models: CascadeModels, world, users: np.ndarray,
                            *, item_block: int = 256) -> dict:
    """Score the full corpus with every stage model -> {name: (U, I)}
    float32 host arrays, on the models' device."""
    items = corpus_items(models, world.item_cat)
    ub = _user_batch(world, users, items[0].device)
    return {name: score_corpus(models, name, ub, items,
                               item_block=item_block).cpu().numpy()
            for name in STAGE_MODELS}


# ---------------------------------------------------------------------------
# Shared sorted orderings and the NumPy oracle
# ---------------------------------------------------------------------------


@dataclass
class RankedScores:
    """Per-model global item orderings shared by all chains:
    ``orders[m, u]`` lists item ids in descending score order of model
    ``names[m]`` (stable: ties by item id), ``ranks[m, u]`` the inverse
    permutation."""

    names: tuple  # (M,) model names, axis 0 of orders/ranks
    orders: np.ndarray  # (M, U, I) int32
    ranks: np.ndarray  # (M, U, I) int32

    @property
    def slot(self) -> dict:
        return {n: m for m, n in enumerate(self.names)}


def rank_stage_scores(stage_scores: dict) -> RankedScores:
    """Stable-argsort every stage model's scores once."""
    names = tuple(stage_scores)
    mats = [np.asarray(stage_scores[n]) for n in names]
    u, i = mats[0].shape
    orders = np.empty((len(names), u, i), np.int32)
    ranks = np.empty_like(orders)
    pos = np.broadcast_to(np.arange(i, dtype=np.int32), (u, i))
    for m, s in enumerate(mats):
        o = np.argsort(-s, axis=1, kind="stable").astype(np.int32)
        orders[m] = o
        np.put_along_axis(ranks[m], o, pos, axis=1)
    return RankedScores(names, orders, ranks)


def chain_plan(chains: ActionChainSet, slot: dict, *, expose: int,
               n_items: int) -> tuple[np.ndarray, np.ndarray]:
    """(model_slots (J, K), keeps (J, K)) int32: stage k of chain j
    scores with model ``model_slots[j, k]`` and keeps the first
    ``keeps[j, k]`` survivors; keeps[:, 0] folds the stage-0 scale in
    (top-n1 then top-n2 by one score is top-min(n1, n2)), the last stage
    keeps ``expose``."""
    j_n, k_n = chains.chain_idx.shape[:2]
    slots = np.zeros((j_n, k_n), np.int32)
    keeps = np.zeros((j_n, k_n), np.int32)
    for j in range(j_n):
        for k in range(k_n):
            mi = int(chains.chain_idx[j, k, 0])
            slots[j, k] = slot[chains.stages[k].models[mi].name]
            if k < k_n - 1:
                keeps[j, k] = int(chains.scale_value[j, k + 1])
            else:
                keeps[j, k] = expose
        keeps[j, 0] = min(keeps[j, 0], int(chains.scale_value[j, 0]),
                          n_items)
    return slots, keeps


def _truncate_np(surv: np.ndarray, order: np.ndarray, rank: np.ndarray,
                 keep: int) -> np.ndarray:
    """Keep the first ``keep`` survivors along ``order`` (one stage)."""
    so = np.take_along_axis(surv, order, axis=1)
    q = np.cumsum(so, axis=1) - so  # exclusive: survivors strictly before
    so &= q < keep
    return np.take_along_axis(so, rank, axis=1)


def run_chain(stage_scores: dict, chain_desc: tuple, clicks: np.ndarray,
              *, expose: int = 20) -> np.ndarray:
    """One chain for all users, the NumPy reference: chain_desc = (n1,
    n2, n3, rank_model_name), clicks (U, I) -> per-user revenue@expose
    with keeps (min(n1, n2), n3, expose)."""
    n1, n2, n3, rank_name = chain_desc
    i = clicks.shape[1]
    surv = np.ones(clicks.shape, bool)
    pos = np.broadcast_to(np.arange(i, dtype=np.int32), clicks.shape)
    for name, keep in (("DSSM", min(int(n1), int(n2))), ("YDNN", int(n3)),
                       (rank_name, int(expose))):
        order = np.argsort(-np.asarray(stage_scores[name]), axis=1,
                           kind="stable").astype(np.int32)
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, pos, axis=1)
        surv = _truncate_np(surv, order, rank, keep)
    return (surv * clicks).sum(axis=1).astype(np.float32)


def simulate_revenue_matrix_reference(stage_scores: dict,
                                      chains: ActionChainSet,
                                      clicks: np.ndarray, *,
                                      expose: int = 20) -> np.ndarray:
    """Per-chain loop over ``run_chain`` - the brute-force oracle."""
    u = clicks.shape[0]
    out = np.zeros((u, chains.n_chains), np.float32)
    k_rank = chains.n_stages - 1
    for j in range(chains.n_chains):
        n1, n2, n3 = (int(chains.scale_value[j, k]) for k in range(3))
        mi = int(chains.chain_idx[j, k_rank, 0])
        rank_name = chains.stages[k_rank].models[mi].name
        out[:, j] = run_chain(stage_scores, (n1, n2, n3, rank_name), clicks,
                              expose=expose)
    return out


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


def _simulate_k3_numpy(stage_scores: dict, lay: dict, clicks: np.ndarray,
                       *, expose: int,
                       order1: np.ndarray | None = None) -> np.ndarray:
    """Compaction path for the paper cascade layout -> (J, U) revenue in
    the layout's group order: after one recall argsort every chain is
    threshold arithmetic on (U, cap) rows (n3 keeps prefix positions
    < n3, exposure the first ``expose`` of those in rank-model order)."""
    gk = lay["group_key"]
    g_n = len(gk)
    p_sorted, clicks_sorted, cap = _compact_group_tables(
        stage_scores, lay, clicks, order1=order1, expose=expose)
    qdt = p_sorted.dtype
    k_max = max(len(g[2]) for g in gk)
    n3_pad = np.zeros((g_n, k_max), qdt)
    for g, (_, _, n3list) in enumerate(gk):
        n3_pad[g, :len(n3list)] = [min(n, cap) for n in n3list]
    mask = p_sorted[:, None, :, :] < n3_pad[:, :, None, None]
    q3 = np.cumsum(mask, axis=3, dtype=qdt)  # inclusive survivor count
    mask &= q3 <= expose
    rev = np.einsum("gkuc,guc->gku", mask, clicks_sorted)
    rows = [rev[g, :len(n3list)] for g, (_, _, n3list) in enumerate(gk)]
    return np.concatenate(rows, axis=0)


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


def build_compact_plan(stage_scores: dict, chains: ActionChainSet,
                       clicks: np.ndarray, *,
                       expose: int) -> CompactPlan | None:
    """CompactPlan for a materialized user universe, or None off the k3
    layout."""
    lay = _k3_layout(chains, n_items=clicks.shape[1])
    if lay is None:
        return None
    p_sorted, clicks_sorted, cap = _compact_group_tables(
        stage_scores, lay, np.asarray(clicks, np.float32), expose=expose)
    g_of, n3_of = _layout_chain_maps(lay, chains.n_chains, cap)
    return CompactPlan(p_sorted.astype(np.int32),
                       clicks_sorted.astype(np.float32), g_of, n3_of,
                       int(cap), int(expose))


def _survive(surv, order, rank, keep):
    """One stage on (B, I) survivor masks: keep the first ``keep`` (B,)
    survivors along each row's ``order``."""
    so = torch.gather(surv, 1, order)
    si = so.to(torch.int32)
    q = torch.cumsum(si, dim=1) - si
    so = so & (q < keep[:, None])
    return torch.gather(so, 1, rank)


def _revenue_all_chains(orders, ranks, clicks, slots, keeps, *,
                        n_stages: int):
    """(U, J) revenue of every chain for every user on tensors: orders
    and ranks (M, U, I), clicks (U, I) f32, slots/keeps (J, K)."""
    orders, ranks = orders.long(), ranks.long()
    u_n = clicks.shape[0]
    cols = []
    for j in range(slots.shape[0]):
        surv = torch.ones(clicks.shape, dtype=torch.bool,
                          device=clicks.device)
        for k in range(n_stages):
            m = int(slots[j, k])
            surv = _survive(surv, orders[m], ranks[m],
                            keeps[j, k].expand(u_n))
        cols.append(torch.sum(torch.where(surv, clicks, 0.0), dim=1))
    return torch.stack(cols, dim=1)


def _revenue_requests(orders, ranks, clicks, slots, keeps, rows, *,
                      n_stages: int):
    """Per-request revenue: request b = (user rows[b], chain with model
    slots slots[b] and keeps keeps[b]), any stage layout, in one batched
    pass over the requests."""
    rows = rows.long()
    slots = slots.long()
    surv = torch.ones((rows.shape[0], clicks.shape[1]), dtype=torch.bool,
                      device=clicks.device)
    for k in range(n_stages):
        surv = _survive(surv, orders[slots[:, k], rows].long(),
                        ranks[slots[:, k], rows].long(), keeps[:, k])
    return torch.sum(torch.where(surv, clicks[rows], 0.0), dim=1)


def simulate_revenue_matrix(stage_scores: dict, chains: ActionChainSet,
                            clicks: np.ndarray, *, expose: int = 20,
                            ranked: RankedScores | None = None
                            ) -> np.ndarray:
    """Ground-truth revenue of every chain for every user -> (U, J): the
    reward model's training samples and the oracle for evaluating
    allocations.  Equal to ``simulate_revenue_matrix_reference``."""
    lay = _k3_layout(chains, n_items=clicks.shape[1])
    if lay is not None:
        order1 = (ranked.orders[ranked.slot[lay["stage_names"][0]]]
                  if ranked is not None else None)
        grouped = _simulate_k3_numpy(stage_scores, lay,
                                     np.asarray(clicks, np.float32),
                                     expose=expose, order1=order1)
        out = np.empty((clicks.shape[0], chains.n_chains), np.float32)
        out[:, lay["chain_order"]] = grouped.T
        return out
    ranked = ranked or rank_stage_scores(stage_scores)
    slots, keeps = chain_plan(chains, ranked.slot, expose=expose,
                              n_items=clicks.shape[1])
    rev = _revenue_all_chains(
        torch.from_numpy(ranked.orders), torch.from_numpy(ranked.ranks),
        torch.as_tensor(np.asarray(clicks, np.float32)),
        torch.from_numpy(slots), torch.from_numpy(keeps),
        n_stages=chains.n_stages)
    return rev.numpy()


class CascadeServer:
    """Online execution of allocated chains over a materialized user
    universe (precomputed stage scores and clicks for its users).

    ``compact`` is the CompactPlan of the k3 layout (None elsewhere);
    ``tables`` holds its (G, U, cap) tables on ``device`` for the
    serving pipeline.  ``serve`` executes through the
    ``cascade_truncate`` kernel on the card and its plain version on the
    CPU wherever the layout has a compact plan; ``_revenue_requests``
    runs only where it has none.  ``device`` defaults to the card and
    raises without one."""

    def __init__(self, stage_scores: dict, chains: ActionChainSet,
                 clicks: np.ndarray, expose: int = 20, *, device=None):
        from repro_torch.device import resolve_device

        self.device = dev = resolve_device(device)
        self.stage_scores = stage_scores
        self.chains = chains
        self.clicks = clicks
        self.expose = int(expose)
        self._ranked = rank_stage_scores(stage_scores)
        self._slots, self._keeps = chain_plan(
            chains, self._ranked.slot, expose=self.expose,
            n_items=clicks.shape[1])
        self.compact = build_compact_plan(stage_scores, chains, clicks,
                                          expose=self.expose)
        self.tables = None
        if self.compact is not None:
            c = self.compact
            self.tables = {
                "p": torch.as_tensor(c.p_sorted, device=dev),
                "ck": torch.as_tensor(c.clicks_sorted, device=dev),
                "g_of": torch.as_tensor(c.group_of_chain, device=dev),
                "n3_of": torch.as_tensor(c.n3_of_chain, device=dev)}
        self._scan = None  # the generic layout's tensors, made on use

    def serve(self, user_rows: np.ndarray, decisions: np.ndarray):
        """user_rows: indices into the score matrices; decisions: (B,)
        chain ids.  Returns (revenue (B,) ndarray, flops (B,))."""
        decisions = np.asarray(decisions, np.int64)
        rows = torch.as_tensor(np.asarray(user_rows, np.int64),
                               device=self.device)
        dec = torch.as_tensor(decisions, device=self.device)
        if self.tables is not None:
            t = self.tables
            rev = _revenue_compact(t["p"], t["ck"], t["g_of"][dec], rows,
                                   t["n3_of"][dec], expose=self.expose)
        else:
            if self._scan is None:
                dev = self.device
                self._scan = (
                    torch.as_tensor(self._ranked.orders, device=dev),
                    torch.as_tensor(self._ranked.ranks, device=dev),
                    torch.as_tensor(np.asarray(self.clicks, np.float32),
                                    device=dev),
                    torch.as_tensor(self._slots, device=dev),
                    torch.as_tensor(self._keeps, device=dev))
            orders, ranks, clicks, slots, keeps = self._scan
            rev = _revenue_requests(orders, ranks, clicks, slots[dec],
                                    keeps[dec], rows,
                                    n_stages=self.chains.n_stages)
        return rev.cpu().numpy(), self.chains.costs[decisions]


def _revenue_compact(p_sorted, clicks_sorted, groups, rows, n3, *,
                     expose: int):
    """Per-request revenue on CompactPlan tables: request b reads row
    (groups[b], rows[b]) and keeps survivor positions < n3[b], exposing
    the first ``expose`` - the ``cascade_truncate`` kernel on the card,
    its plain version on the CPU."""
    return ops.cascade_truncate(p_sorted, clicks_sorted, groups, rows, n3,
                                expose=expose)
