"""RequestSource: generate, score and serve request windows on the fly.

Each window is produced on demand as a ``WindowChunk``: sampled
arrivals, their reward contexts, and a PER-WINDOW (G, n, cap) slice of
compact execution tables - the decision-independent cascade arithmetic
for exactly the users who showed up.  Host memory scales with the
window, never with the user universe.

``GeneratedSource`` is the open-world path: arrivals from an unbounded
``StreamingWorld``, user rows hash-generated on demand, the four stage
models scored over the whole corpus on the device at a FIXED chunk
shape, clicks realized per (user, item), and the tables compacted on
the device (``_compact_group_tables_torch``) - the scores never leave
the card.  Each phase runs under a ``torch.profiler.record_function``
range (``world/slab``, ``score/<model>``, ``tables/compact``) so a
profiler trace attributes device time to it; outside a profiler the
ranges cost a few microseconds each.

``source.universe`` is the server-shaped handle a streaming
``ServingPipeline`` is built over: the chain set and compact layout
without per-user tables; every window brings its chunk's tables.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.cascade.engine import (CascadeModels, CompactPlan,
                                        _compact_group_tables_torch,
                                        _k3_layout, _user_batch,
                                        build_compact_layout)
from repro_torch.data.synthetic import StreamingWorld
from repro_torch.device import resolve_device
from repro_torch.models.recsys import dien, din, dssm, ydnn


@dataclass
class WindowChunk:
    """One window's worth of requests, self-contained: ``rows`` are
    LOCAL indices (0..n-1) into the chunk's own (G, n, cap) tables;
    ``users`` keeps the global ids for logging only."""

    ctx: np.ndarray  # (n, d_context) float32 reward contexts
    rows: np.ndarray  # (n,) int32 local row indices (arange)
    tables: dict  # {"p": (G, n, cap) int32, "ck": (G, n, cap) float32}
    users: np.ndarray | None = None  # (n,) global user ids
    h2d_bytes: int = 0  # host->device bytes this chunk's production cost

    @property
    def n(self) -> int:
        return int(len(self.rows))


@dataclass
class StreamUniverse:
    """Chain set + compact layout (group maps and row width, EMPTY
    per-user tables); ``stream_only`` marks that every window must bring
    its chunk's tables."""

    chains: object
    compact: CompactPlan
    expose: int
    stream_only: bool = True


class RequestSource:
    """Base: arrival sampling + per-window chunk production.  Window t
    is a pure function of (seed, t)."""

    chains = None
    expose: int = 0
    n_users: int = 0
    seed: int = 0

    def arrivals(self, t: int, n: int) -> np.ndarray:
        """(n,) sampled user ids for window t (uniform arrivals)."""
        rng = np.random.default_rng((self.seed, t))
        return rng.integers(0, self.n_users, size=n)

    def window(self, t: int, n: int) -> WindowChunk:
        raise NotImplementedError

    @property
    def universe(self) -> StreamUniverse:
        lay = build_compact_layout(self.chains, n_items=self._n_items(),
                                   expose=self.expose)
        if lay is None:
            raise ValueError(
                "streaming sources need the k3 cascade layout (single "
                "recall/prerank model pools)")
        return StreamUniverse(self.chains, lay, self.expose)

    def _n_items(self) -> int:
        raise NotImplementedError


class GeneratedSource(RequestSource):
    """On-the-fly request generation from a ``StreamingWorld``.

    Per window: sample arrivals, hash-materialize exactly those user
    rows, score the stage models over the corpus in chunks padded to
    ``chunk`` users (one shape for any traffic level; DIN and DIEN in
    blocks of ``item_block`` candidates), realize per-(user, item)
    clicks and compact the (chunk, I) scores into (G, chunk, cap) tables
    on the device, sliced to the real rows.  ``device`` defaults to the
    card and raises without one.
    """

    def __init__(self, world: StreamingWorld, models: CascadeModels,
                 chains, *, expose: int, seed: int = 0, chunk: int = 512,
                 item_block: int = 256, device=None):
        self.device = resolve_device(device)
        self.world = world
        self.models = models
        self.chains = chains
        self.expose = int(expose)
        self.seed = int(seed)
        self.chunk = int(chunk)
        self.item_block = int(item_block)
        self.n_users = int(world.cfg.n_users)
        self._lay = _k3_layout(chains, n_items=world.cfg.n_items)
        if self._lay is None:
            raise ValueError("GeneratedSource needs the k3 cascade layout")
        dev = self.device
        n_items = world.cfg.n_items
        self._item_ids = torch.arange(n_items, device=dev)
        self._item_cats = torch.as_tensor(world.item_cat, device=dev)
        self._dssm_items = None  # corpus item-tower vectors (lazy)

    def _n_items(self) -> int:
        return int(self.world.cfg.n_items)

    @property
    def d_context(self) -> int:
        return self.world.d_context

    # -- fixed-shape stage scoring on the device ---------------------------

    @torch.no_grad()
    def score_slab(self, ub: dict) -> dict:
        """{name: (chunk, I) f32} stage scores for a padded user batch."""
        m = self.models
        n_items = self._n_items()
        if self._dssm_items is None:
            if m.dssm_cfg.n_item_fields == 1:
                fields = self._item_cats[:, None]
            else:
                fields = torch.stack([self._item_ids, self._item_cats], -1)
            self._dssm_items = dssm.item_tower(m.dssm_params, m.dssm_cfg,
                                               fields)
        c = ub["user_fields"].shape[0]
        scores = {}
        with record_function("score/DSSM"):
            scores["DSSM"] = dssm.user_tower(
                m.dssm_params, m.dssm_cfg,
                ub["user_fields"]) @ self._dssm_items.T
        with record_function("score/YDNN"):
            scores["YDNN"] = ydnn.user_vector(
                m.ydnn_params, m.ydnn_cfg, ub["hist_ids"], ub["hist_mask"],
                ub["user_fields"]) \
                @ m.ydnn_params["out_emb"]["table"][:n_items].T
        for name, mod, params, cfg in (
                ("DIN", din, m.din_params, m.din_cfg),
                ("DIEN", dien, m.dien_params, m.dien_cfg)):
            cols = []
            with record_function(f"score/{name}"):
                for lo in range(0, n_items, self.item_block):
                    hi = min(n_items, lo + self.item_block)
                    ids = self._item_ids[lo:hi].expand(c, hi - lo)
                    cats = self._item_cats[lo:hi].expand(c, hi - lo)
                    cols.append(mod.score(params, cfg, ub, ids, cats))
                scores[name] = torch.cat(cols, dim=1)
        return scores

    def _chunk_tables(self, ids: np.ndarray):
        """One scoring chunk -> (ctx, p, ck, h2d_bytes), tables on the
        device sliced to the chunk's real rows."""
        m = len(ids)
        with record_function("world/slab"):
            slab = self.world.user_slab(ids)
            ctx = slab.reward_context(np.arange(m))
            ub = _user_batch(slab, np.arange(m), self.device,
                             pad_to=self.chunk)
            clicks = self.world.clicks_slab(ids, slab, pad_rows=self.chunk)
        h2d = sum(int(v.numel()) * v.element_size() for v in ub.values())
        h2d += clicks.nbytes
        scores = self.score_slab(ub)
        with record_function("tables/compact"):
            p, ck = _compact_group_tables_torch(
                scores, self._lay, torch.from_numpy(clicks).to(self.device))
        return ctx, p[:, :m], ck[:, :m], h2d

    # -- window production -------------------------------------------------

    def window(self, t: int, n: int) -> WindowChunk:
        if n == 0:
            lay = build_compact_layout(self.chains, n_items=self._n_items(),
                                       expose=self.expose)
            g_n, cap = lay.p_sorted.shape[0], lay.cap
            return WindowChunk(
                ctx=np.zeros((0, self.d_context), np.float32),
                rows=np.zeros(0, np.int32),
                tables={"p": torch.zeros((g_n, 0, cap), dtype=torch.int32,
                                         device=self.device),
                        "ck": torch.zeros((g_n, 0, cap), device=self.device)},
                users=np.zeros(0, np.int64))
        return self.window_for_users(self.arrivals(t, n))

    def window_for_users(self, users: np.ndarray) -> WindowChunk:
        """Chunk for an explicit arrival list (rows = arange(len))."""
        users = np.asarray(users)
        n = len(users)
        parts = [self._chunk_tables(users[lo:lo + self.chunk])
                 for lo in range(0, n, self.chunk)]
        if len(parts) == 1:
            ctx, p, ck, h2d = parts[0]
        else:
            ctx = np.concatenate([pt[0] for pt in parts], axis=0)
            p = torch.cat([pt[1] for pt in parts], dim=1)
            ck = torch.cat([pt[2] for pt in parts], dim=1)
            h2d = sum(pt[3] for pt in parts)
        return WindowChunk(ctx=np.asarray(ctx, np.float32),
                           rows=np.arange(n, dtype=np.int32),
                           tables={"p": p, "ck": ck}, users=users,
                           h2d_bytes=int(h2d))
