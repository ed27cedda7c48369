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
the card.  The scoring runs as fixed-shape programs (``graphs.Program``:
one CUDA graph per stage model and one for the compaction, the port's
``jax.jit``), a slab-keyed LRU cache of chunk tables lets repeat
arrivals skip hashing and scoring, and ``workers`` chunk scorers serve
a multi-chunk window on a thread pool.  Each phase runs under a
``torch.profiler.record_function`` range (``world/slab``,
``score/<model>``, ``tables/compact``, around the replays) so a profiler
trace attributes device time to it; outside a profiler the ranges cost
a few microseconds each.

``TableReplaySource`` is the fixed-replay path: per-user tables computed
once (by a materialized ``CascadeServer``, or a ``save`` of either
package, loaded memmapped so only the rows a window touches page in),
windows gathering row slices.  Built ``from_server`` it serves bit for
bit what the materialized server serves.

``source.universe`` is the server-shaped handle a streaming
``ServingPipeline`` is built over: the chain set and compact layout
without per-user tables; every window brings its chunk's tables.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.cascade.engine import (STAGE_MODELS, CascadeModels,
                                        CompactPlan,
                                        _compact_group_tables_torch,
                                        _k3_layout, _user_batch,
                                        build_compact_layout, compact_index,
                                        corpus_items, score_corpus)
from repro_torch.data.synthetic import StreamingWorld
from repro_torch.device import resolve_device
from repro_torch.graphs import Program, consume, record_event, side_stream
from repro_torch.obs import get_obs


@dataclass
class WindowChunk:
    """One window's worth of requests, self-contained: ``rows`` are
    LOCAL indices (0..n-1) into the chunk's own (G, n, cap) tables;
    ``users`` keeps the global ids for logging only.  In a multi-process
    stream a chunk is one host's padded rows of the window and ``shard``
    (a ``distributed.multihost.HostWindowSlice``) its global layout;
    ``n`` is then the window's global request count."""

    ctx: np.ndarray  # (n, d_context) float32 reward contexts
    rows: np.ndarray  # (n,) int32 local row indices (arange)
    tables: dict  # {"p": (G, n, cap) int32, "ck": (G, n, cap) float32}
    users: np.ndarray | None = None  # (n,) global user ids
    h2d_bytes: int = 0  # host->device bytes this chunk's production cost
    ready: object = None  # CUDA event after which the tables are complete
    shard: object | None = None  # HostWindowSlice in a multi-host stream

    @property
    def n(self) -> int:
        if self.shard is not None:
            return int(self.shard.n)
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


class _ScoringProgram:
    """One chunk scorer: static device buffers at the chunk shape (the
    model batch and the padded clicks), pinned staging buffers for them,
    a CUDA stream of its own, and one ``Program`` per stage model plus
    one for the table compaction, sharing one graph pool.  One thread at
    a time uses it (``GeneratedSource`` hands programs out)."""

    def __init__(self, src: "GeneratedSource", capture: bool):
        dev, c, cfg = src.device, src.chunk, src.world.cfg
        shapes = {"user_fields": ((c, cfg.n_user_fields), torch.int64),
                  "hist_ids": ((c, cfg.hist_len), torch.int64),
                  "hist_cats": ((c, cfg.hist_len), torch.int64),
                  "hist_mask": ((c, cfg.hist_len), torch.float32),
                  "clicks": ((c, cfg.n_items), torch.float32)}
        self.inputs = {k: torch.zeros(s, dtype=dt, device=dev)
                       for k, (s, dt) in shapes.items()}
        self.staging = {k: torch.zeros(s, dtype=dt,
                                       pin_memory=dev.type == "cuda")
                        for k, (s, dt) in shapes.items()}
        self.stream = side_stream(dev)
        self.copied = None  # event: the staging buffers' copies are done
        kw = dict(capture=capture, stream=self.stream,
                  pool=torch.cuda.graph_pool_handle() if capture else None)
        ub = {k: v for k, v in self.inputs.items() if k != "clicks"}

        def scorer(name):
            return lambda: {"scores": src.score_model(name, ub)}

        self.models = {name: Program(scorer(name), **kw)
                       for name in STAGE_MODELS}

        def compact():
            p, ck = _compact_group_tables_torch(
                {k: prog.out["scores"] for k, prog in self.models.items()},
                src._lay, self.inputs["clicks"], src._index)
            return {"p": p, "ck": ck}

        self.tables = Program(compact, **kw)
        if capture:  # capture at construction, on the zero batch
            with torch.cuda.stream(self.stream):
                for prog in (*self.models.values(), self.tables):
                    prog()

    def run(self, src: "GeneratedSource", ids: np.ndarray):
        """One chunk of arrivals -> (ctx, p, ck, ready, h2d_bytes): the
        tables are copies, complete on the device after ``ready``."""
        m = len(ids)
        with record_function("world/slab"):
            slab = src.world.user_slab(ids)
            ctx = slab.reward_context(np.arange(m))
            clicks = src.world.clicks_slab(ids, slab, pad_rows=src.chunk)
            if self.copied is not None:
                self.copied.synchronize()  # staging free again
            with torch.cuda.stream(self.stream):
                _user_batch(slab, np.arange(m), src.device, pad_to=src.chunk,
                            out=self.inputs, staging=self.staging)
                self.staging["clicks"].numpy()[:] = clicks
                self.inputs["clicks"].copy_(self.staging["clicks"],
                                            non_blocking=True)
                self.copied = record_event(self.stream)
        with torch.cuda.stream(self.stream):
            for name, prog in self.models.items():
                with record_function(f"score/{name}"):
                    prog()
            with record_function("tables/compact"):
                out = self.tables()
                # copies: the next replay overwrites the static outputs
                p, ck = out["p"][:, :m].clone(), out["ck"][:, :m].clone()
            ready = record_event(self.stream)
        h2d = sum(v.numel() * v.element_size() for v in self.staging.values())
        return ctx, p, ck, ready, h2d


class GeneratedSource(RequestSource):
    """On-the-fly request generation from a ``StreamingWorld``.

    Per window: sample arrivals, hash-materialize exactly those user
    rows, score the stage models over the corpus in chunks padded to
    ``chunk`` users (one shape for any traffic level; DIN and DIEN in
    blocks of ``item_block`` candidates), realize per-(user, item)
    clicks and compact the (chunk, I) scores into (G, chunk, cap) tables
    on the device, sliced to the real rows.  ``device`` defaults to the
    card and raises without one.

    On the card each of ``workers`` chunk scorers captures its stage
    models and the compaction as CUDA graphs at construction, on a
    stream of its own; chunk tables then reach a consumer on another
    stream through ``WindowChunk.ready`` (``graphs.consume``).  A
    scorer's graph pool holds its capture's peak - 20.2 GB at the full
    width, 512 users against 4,000 items, most of it DIEN's attention
    features (PERF.md) - so ``workers`` defaults to one.  A slab-keyed LRU
    cache of ``table_cache`` chunk tables returns repeat arrivals without
    scoring (``cache_hits``/``cache_misses``); a chunk is a pure function
    of its arrival ids, so a hit, and a window scored on the pool, is
    bitwise the sequential result.  ``obs`` mirrors the cache counters
    into its registry and wraps each window's chunk production
    (``window``) in a ``chunk_tables`` span.
    """

    def __init__(self, world: StreamingWorld, models: CascadeModels,
                 chains, *, expose: int, seed: int = 0, chunk: int = 512,
                 item_block: int = 256, table_cache: int = 64,
                 workers: int = 1, obs=None, device=None):
        self.device = dev = resolve_device(device)
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
        self._index = compact_index(self._lay, dev)
        self._items = corpus_items(models, world.item_cat)  # once
        self._cache: OrderedDict = OrderedDict()  # slab key -> tables
        self._cache_cap = int(table_cache)
        self._lock = threading.Lock()
        # the plain ints stay authoritative; the obs counters mirror them
        self.cache_hits = 0
        self.cache_misses = 0
        self.obs = get_obs(obs)
        self._hits_c = self.obs.metrics.counter(
            "greenflow_table_cache_hits_total",
            "slab-table cache hits (a hit IS the chunk result)")
        self._misses_c = self.obs.metrics.counter(
            "greenflow_table_cache_misses_total",
            "slab-table cache misses (chunk scored + compacted)")
        self.workers = int(workers)
        self._pool = None
        self._stream = side_stream(dev)  # joins a window's chunks
        capture = dev.type == "cuda"
        self.programs = [_ScoringProgram(self, capture)
                         for _ in range(self.workers)]
        self._free: queue.SimpleQueue = queue.SimpleQueue()
        for prog in self.programs:
            self._free.put(prog)

    def _n_items(self) -> int:
        return int(self.world.cfg.n_items)

    @property
    def d_context(self) -> int:
        return self.world.d_context

    def close(self) -> None:
        """Shut the chunk-scorer thread pool down (if one was started)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    # -- fixed-shape stage scoring on the device ---------------------------

    def score_model(self, name: str, ub: dict):
        """(chunk, I) f32 scores of one stage model for a padded user
        batch, eagerly."""
        return score_corpus(self.models, name, ub, self._items,
                            item_block=self.item_block)

    def score_slab(self, ub: dict) -> dict:
        """{name: (chunk, I) f32} stage scores for a padded user batch,
        eagerly: the reference the scoring programs replay."""
        return {name: self.score_model(name, ub) for name in STAGE_MODELS}

    def _chunk_tables(self, ids: np.ndarray):
        """One scoring chunk -> (ctx, p, ck, ready, h2d_bytes), tables on
        the device sliced to the chunk's real rows; from the slab cache
        when these exact arrivals were produced before (a hit is the
        result: a chunk is a pure function of its ids)."""
        key = (len(ids), ids.tobytes())
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                self._hits_c.inc()
                return (*hit, 0)
            self.cache_misses += 1
            self._misses_c.inc()
        prog = self._free.get()  # never two threads on one program
        try:
            ctx, p, ck, ready, h2d = prog.run(self, ids)
        finally:
            self._free.put(prog)
        with self._lock:
            self._cache[key] = (ctx, p, ck, ready)
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return ctx, p, ck, ready, h2d

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
        users = self.arrivals(t, n)
        with self.obs.span("chunk_tables", t=t, n=n,
                           chunks=-(-n // self.chunk)):
            return self.window_for_users(users)

    def window_for_users(self, users: np.ndarray) -> WindowChunk:
        """Chunk for an explicit arrival list (rows = arange(len))."""
        users = np.asarray(users)
        n = len(users)
        chunk_ids = [users[lo:lo + self.chunk]
                     for lo in range(0, n, self.chunk)]
        if self.workers > 1 and len(chunk_ids) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="chunk-score")
            parts = list(self._pool.map(self._chunk_tables, chunk_ids))
        else:
            parts = [self._chunk_tables(ids) for ids in chunk_ids]
        if len(parts) == 1:
            ctx, p, ck, ready, h2d = parts[0]
        else:
            ctx = np.concatenate([pt[0] for pt in parts], axis=0)
            with torch.cuda.stream(self._stream):
                for pt in parts:
                    consume(pt[1:3], pt[3])
                p = torch.cat([pt[1] for pt in parts], dim=1)
                ck = torch.cat([pt[2] for pt in parts], dim=1)
                ready = record_event(self._stream)
            h2d = sum(pt[4] for pt in parts)
        return WindowChunk(ctx=np.asarray(ctx, np.float32),
                           rows=np.arange(n, dtype=np.int32),
                           tables={"p": p, "ck": ck}, users=users,
                           h2d_bytes=int(h2d), ready=ready)


class TableReplaySource(RequestSource):
    """Fixed replay over precomputed per-user tables: contexts (U, d) and
    the (G, U, cap) CompactPlan rows, from a materialized
    ``CascadeServer`` (``from_server``) or a saved universe (``load``).
    Windows gather their arrivals' rows, so a replay built
    ``from_server`` is bitwise the materialized server's windows.

    ``device_tables`` puts the universe's tables on ``device`` once and
    makes each window an ``index_select`` along the user axis there, with
    no per-window (G, n, cap) host-to-device copy; it defaults to on for
    in-memory tables and off for memmapped ones, whose untouched rows
    never leave the disk (their windows carry host arrays, which the
    pipeline copies).  ``device`` defaults to the card and raises without
    one.  ``save`` writes the JAX package's format (``ctx.npy``,
    ``p_sorted.npy``, ``clicks_sorted.npy``, ``meta.json``), so either
    package loads the other's universe."""

    def __init__(self, ctx: np.ndarray, p_sorted: np.ndarray,
                 clicks_sorted: np.ndarray, chains, *, n_items: int,
                 expose: int, seed: int = 0,
                 device_tables: bool | None = None, device=None):
        if ctx.shape[0] != p_sorted.shape[1]:
            raise ValueError(
                f"ctx rows ({ctx.shape[0]}) must match table users "
                f"({p_sorted.shape[1]})")
        self.device = resolve_device(device)
        self.ctx = ctx
        self.p_sorted = p_sorted
        self.clicks_sorted = clicks_sorted
        self.chains = chains
        self.n_items = int(n_items)
        self.expose = int(expose)
        self.seed = int(seed)
        self.n_users = int(ctx.shape[0])
        if device_tables is None:
            device_tables = not isinstance(p_sorted, np.memmap)
        self.device_tables = bool(device_tables)
        self._dev = None  # the universe's tables on the device (lazy)
        lay = build_compact_layout(chains, n_items=self.n_items,
                                   expose=self.expose)
        if lay is None or lay.cap != p_sorted.shape[2]:
            raise ValueError(
                f"tables (cap={p_sorted.shape[2]}) do not match the "
                f"chain set's compact layout at n_items={self.n_items}")

    @classmethod
    def from_server(cls, server, ctx: np.ndarray, *, seed: int = 0,
                    device_tables: bool | None = None,
                    device=None) -> "TableReplaySource":
        """Replay over a materialized ``CascadeServer``'s universe (``ctx``
        row u is the reward context of table row u), on the server's
        device unless ``device`` is given."""
        if server.compact is None:
            raise ValueError("from_server needs a CompactPlan server "
                             "(the k3 cascade layout)")
        return cls(np.asarray(ctx, np.float32),
                   np.asarray(server.compact.p_sorted, np.int32),
                   np.asarray(server.compact.clicks_sorted, np.float32),
                   server.chains, n_items=server.clicks.shape[1],
                   expose=server.compact.expose, seed=seed,
                   device_tables=device_tables,
                   device=server.device if device is None else device)

    def _n_items(self) -> int:
        return self.n_items

    @property
    def d_context(self) -> int:
        return int(self.ctx.shape[1])

    def window(self, t: int, n: int) -> WindowChunk:
        return self.window_for_users(self.arrivals(t, n))

    def window_for_users(self, users: np.ndarray) -> WindowChunk:
        """Chunk for an explicit arrival list (rows = arange(len))."""
        users = np.asarray(users)
        n = len(users)
        ctx = np.asarray(self.ctx[users], np.float32)
        rows = np.arange(n, dtype=np.int32)
        if not self.device_tables:
            return WindowChunk(
                ctx=ctx, rows=rows,
                tables={"p": np.ascontiguousarray(self.p_sorted[:, users]),
                        "ck": np.ascontiguousarray(
                            self.clicks_sorted[:, users])},
                users=users)
        dev = self.device
        h2d = 0
        if self._dev is None:  # the universe goes to the device once
            self._dev = (
                torch.as_tensor(np.asarray(self.p_sorted, np.int32),
                                device=dev),
                torch.as_tensor(np.asarray(self.clicks_sorted, np.float32),
                                device=dev))
            h2d = sum(t.numel() * t.element_size() for t in self._dev)
        u = torch.from_numpy(users.astype(np.int32)).to(dev)
        h2d += u.numel() * u.element_size()
        p = torch.index_select(self._dev[0], 1, u)
        ck = torch.index_select(self._dev[1], 1, u)
        ready = record_event(torch.cuda.current_stream()
                             if dev.type == "cuda" else None)
        return WindowChunk(ctx=ctx, rows=rows, tables={"p": p, "ck": ck},
                           users=users, h2d_bytes=int(h2d), ready=ready)

    # -- the on-disk (memmap) form -----------------------------------------

    def save(self, path: str) -> None:
        """Write the tables as ``.npy`` files (memmap-loadable) and the
        universe's sizes as ``meta.json``."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "ctx.npy"),
                np.asarray(self.ctx, np.float32))
        np.save(os.path.join(path, "p_sorted.npy"),
                np.asarray(self.p_sorted, np.int32))
        np.save(os.path.join(path, "clicks_sorted.npy"),
                np.asarray(self.clicks_sorted, np.float32))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"expose": self.expose, "n_items": self.n_items,
                       "n_users": self.n_users}, f)

    @classmethod
    def load(cls, path: str, chains, *, seed: int = 0, mmap: bool = True,
             device_tables: bool | None = None,
             device=None) -> "TableReplaySource":
        """Open a saved universe; ``mmap=True`` keeps its tables on disk."""
        mode = "r" if mmap else None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return cls(np.load(os.path.join(path, "ctx.npy"), mmap_mode=mode),
                   np.load(os.path.join(path, "p_sorted.npy"),
                           mmap_mode=mode),
                   np.load(os.path.join(path, "clicks_sorted.npy"),
                           mmap_mode=mode),
                   chains, n_items=int(meta["n_items"]),
                   expose=int(meta["expose"]), seed=seed,
                   device_tables=device_tables, device=device)
