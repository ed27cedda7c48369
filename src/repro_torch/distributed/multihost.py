"""Multi-process serving: bring-up, per-host window routing, stream resume.

The serving pipeline scales past one process by sharding the REQUEST
axis of every window over a ``torch.distributed`` process group:
``initialize`` joins the group, ``launch.mesh.make_request_mesh`` builds
the request mesh over it, and ``MultihostSource`` routes each window so
that every host GENERATES its own rows instead of receiving them.

The routing protocol:

  1. Window t's arrival list is a pure function of ``(seed, t)``
     (``RequestSource.arrivals``), so every host computes the FULL list
     and no request is ever shipped between hosts.
  2. Every host derives the same padded layout from ``(n, b)`` alone
     (``serving.pipeline.window_layout``), so the row -> request
     permutation, the validity mask and the tenant map agree everywhere.
  3. ``launch.mesh.process_shard_rows`` names this host's row ranges; the
     host materializes contexts and compact tables for exactly those
     requests (``RequestSource.window_for_users``) and sentinel-fills
     its pad rows (p = cap, ck = 0, the fill the window program pads
     with; masked out by ``valid`` before anything reads them).
  4. Each host scores its rows shard by shard, the hosts gather the
     window's (b, J) rewards once through the host, and every host runs
     the cross-shard seams (Eq. 10, the guard walks, the region split,
     the dual loop) over all S shards with shard-ordered sums
     (``ServingPipeline``): every host agrees bit for bit on the prices,
     spends and decisions, and with the one-process run at the same S.

The collectives go over gloo on the host: several processes may share
one card, and NCCL refuses two ranks on one device.  A gloo group takes
CPU tensors only, so CUDA values are staged through host buffers.

Elasticity is checkpoint and replay: a group cannot change size in
place, so a host joining or leaving checkpoints the stream's small state
(the window cursor, the price chain, the seed; ``checkpoint_stream``),
the new group forms at its own size and resumes at the cursor, replaying
the in-flight window - windows are pure ``(seed, t)`` functions, so the
resumed stream continues exactly where the old one stopped.  The file is
the JAX package's format, so either package resumes the other's stream.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch

from repro_torch.graphs import consume, record_event

_ENV_COORD = "GREENFLOW_COORDINATOR"
_ENV_NPROC = "GREENFLOW_NUM_PROCESSES"
_ENV_PID = "GREENFLOW_PROCESS_ID"
# how long a collective waits for the slowest process before it fails
_TIMEOUT = timedelta(seconds=300)

# -- process-group bring-up -------------------------------------------------


def initialize(*, coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """Join the serving process group (a no-op for one process).

    Arguments default to the ``GREENFLOW_COORDINATOR`` (``host:port`` of
    process 0, which serves the group's store), ``GREENFLOW_NUM_PROCESSES``
    and ``GREENFLOW_PROCESS_ID`` environment variables.  Returns True when
    the group was joined over gloo (``tcp://<coordinator>``), False
    without a coordinator or with one process.  On a machine with cards
    the process then serves from ``cuda:(rank % device_count)`` unless
    ``device`` names one."""
    if coordinator is None:
        coordinator = os.environ.get(_ENV_COORD) or None
    if num_processes is None:
        num_processes = int(os.environ.get(_ENV_NPROC, "1"))
    if process_id is None:
        pid_env = os.environ.get(_ENV_PID)
        process_id = int(pid_env) if pid_env is not None else None
    if coordinator is None or int(num_processes) <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process group needs this process's id "
                         f"(process_id or ${_ENV_PID})")
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_TIMEOUT)
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    elif torch.cuda.is_available():
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_report(mesh=None, device=None) -> dict:
    """This process's view of the group: its index and the group's size,
    its and the mesh's shard counts, the platform and the card's name."""
    from repro_torch.launch.mesh import mesh_local_shards, mesh_num_shards

    rank, world = _rank_world()
    dev = torch.device("cuda" if device is None and
                       torch.cuda.is_available() else device or "cpu")
    on_card = dev.type == "cuda"
    return {
        "process_index": rank,
        "process_count": world,
        "local_shards": mesh_local_shards(mesh),
        "global_shards": mesh_num_shards(mesh),
        "platform": "gpu" if on_card else "cpu",
        "device_name": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
    }


def host_label(index: int | None = None) -> str:
    """The per-host label (``host0``, ``host1``, ...) of flight-recorder
    rows, trace process names and per-host output files."""
    if index is None:
        index = _rank_world()[0]
    return f"host{int(index)}"


def params_digest(params) -> str:
    """SHA-256 of a parameter tree's leaves (their names, dtypes, shapes
    and bytes, in tree order): equal digests on every host mean every
    host serves the same model bit for bit."""
    import hashlib

    from repro_torch.tree import leaves_with_paths

    h = hashlib.sha256()
    for key, leaf in leaves_with_paths(params):
        arr = np.ascontiguousarray(torch.as_tensor(leaf).detach().cpu()
                                   .numpy())
        h.update(f"{key}:{arr.dtype}:{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


# -- cross-host window routing ---------------------------------------------


@dataclass
class HostWindowSlice:
    """This host's slice of one globally laid-out window.

    ``valid``/``k_of``/``rows_global`` cover the host's LOCAL padded rows
    (one contiguous b / S block a local shard, in shard order); ``n`` and
    ``b`` are the GLOBAL request count and bucket every host agrees on.
    ``ServingPipeline.serve_window(..., shard=...)`` takes it instead of
    deriving the layout from ``len(rows)``."""

    n: int  # global request count of the window
    b: int  # global padded bucket (window_bucket(n))
    valid: np.ndarray  # (local_rows,) float32 1 = real request, 0 = pad
    k_of: np.ndarray | None = None  # (local_rows,) tenant ids
    rows_global: np.ndarray | None = None  # (local_rows,) global row ids


class MultihostSource:
    """Route an inner ``RequestSource`` over the request mesh.

    Wraps any source with ``arrivals``/``window_for_users`` (generated or
    replayed) and a mesh-attached ``ServingPipeline``; ``window(t, n)``
    makes THIS host's ``WindowChunk`` of global window t: contexts and
    compact tables for only the rows it owns, sentinel-padded, with the
    ``HostWindowSlice`` that tells ``serve_window`` the global layout.
    ``rows`` index the chunk's own (G, local_rows, cap) tables.  Drop-in
    for ``run_stream``'s ``source``."""

    def __init__(self, inner, pipeline):
        from repro_torch.launch.mesh import mesh_num_shards

        if pipeline.mesh is None:
            raise ValueError("MultihostSource needs a mesh-attached "
                             "pipeline (ServingPipeline(mesh=...))")
        if getattr(pipeline, "_cap", None) is None:
            raise ValueError("multihost routing needs the compact (k3) "
                             "table layout")
        self.inner = inner
        self.pipeline = pipeline
        self.mesh = pipeline.mesh
        self.n_shards = mesh_num_shards(self.mesh)
        # forwarded so run_stream and the launchers treat it as a source
        self.chains = getattr(inner, "chains", None)
        self.expose = getattr(inner, "expose", None)
        self.seed = getattr(inner, "seed", None)

    @property
    def universe(self):
        return self.inner.universe

    def arrivals(self, t: int, n: int) -> np.ndarray:
        return self.inner.arrivals(t, n)

    def window(self, t: int, n: int):
        """THIS host's chunk of global window t (see the module
        docstring for the protocol)."""
        from repro_torch.data.request_source import WindowChunk
        from repro_torch.launch.mesh import process_shard_rows
        from repro_torch.serving.pipeline import window_layout

        pipe = self.pipeline
        users = np.asarray(self.inner.arrivals(t, n))
        b = pipe.window_bucket(n)
        perm, valid, k_of = window_layout(n, b, pipe._cs.t_n)
        rows_global = np.concatenate(
            [np.arange(lo, hi, dtype=np.int64)
             for lo, hi in process_shard_rows(self.mesh, b)])
        valid_l = valid[rows_global]
        mask = valid_l > 0
        mine = users[perm[rows_global][mask]]
        n_local = len(rows_global)
        g_n = len(pipe.server.compact.p_sorted)
        cap = pipe._cap
        ctx_l = np.zeros((n_local, pipe.reward_cfg.d_context), np.float32)
        h2d, ready = 0, None
        if len(mine) == 0:  # this host holds only padding this window
            p_l = np.full((g_n, n_local, cap), cap, np.int32)
            ck_l = np.zeros((g_n, n_local, cap), np.float32)
        else:
            # materialize ONLY this host's real requests, then scatter
            # them into its sentinel-padded rows
            part = self.inner.window_for_users(mine)
            ctx_l[mask] = np.asarray(part.ctx, np.float32)
            h2d = int(getattr(part, "h2d_bytes", 0))
            p_m, ck_m = part.tables["p"], part.tables["ck"]
            if isinstance(p_m, torch.Tensor):  # device tables: on device
                consume((p_m, ck_m), part.ready)
                dev = p_m.device
                at = torch.from_numpy(np.flatnonzero(mask)).to(dev)
                p_l = torch.full((g_n, n_local, cap), cap,
                                 dtype=torch.int32, device=dev)
                p_l.index_copy_(1, at, p_m.to(torch.int32))
                ck_l = torch.zeros((g_n, n_local, cap), device=dev)
                ck_l.index_copy_(1, at, ck_m.to(torch.float32))
                ready = record_event(torch.cuda.current_stream()
                                     if dev.type == "cuda" else None)
            else:
                p_l = np.full((g_n, n_local, cap), cap, np.int32)
                p_l[:, mask, :] = np.asarray(p_m, np.int32)
                ck_l = np.zeros((g_n, n_local, cap), np.float32)
                ck_l[:, mask, :] = np.asarray(ck_m, np.float32)
        shard = HostWindowSlice(
            n=int(n), b=int(b), valid=valid_l.astype(np.float32),
            k_of=None if k_of is None else k_of[rows_global],
            rows_global=rows_global)
        return WindowChunk(ctx=ctx_l,
                           rows=np.arange(n_local, dtype=np.int32),
                           tables={"p": p_l, "ck": ck_l}, users=None,
                           h2d_bytes=h2d, ready=ready, shard=shard)


class ShiftedSource:
    """``inner`` with its window clock shifted by ``t0``: a resumed
    stream serves ``sizes[t0:]`` from local window 0, and the shifted
    source maps local window t back to GLOBAL window t + t0.  Wrap the
    inner source BEFORE handing it to ``MultihostSource``."""

    def __init__(self, inner, t0: int):
        self.inner = inner
        self.t0 = int(t0)
        self.chains = getattr(inner, "chains", None)
        self.expose = getattr(inner, "expose", None)
        self.seed = getattr(inner, "seed", None)

    @property
    def universe(self):
        return self.inner.universe

    def arrivals(self, t: int, n: int) -> np.ndarray:
        return self.inner.arrivals(t + self.t0, n)

    def window(self, t: int, n: int):
        return self.inner.window(t + self.t0, n)

    def window_for_users(self, users: np.ndarray):
        return self.inner.window_for_users(users)


# -- elastic resume (checkpoint and replay) ---------------------------------


@dataclass
class StreamCheckpoint:
    """What a NEW group (any size) needs to resume a stream: the cursor
    of the next window to serve, the price chain (``lam``, and
    ``lam_rec``, the JAX package's recorded copy of it) and the source
    seed.  The in-flight window is not in ``t_next``: the new group
    replays it."""

    t_next: int
    lam: object  # the price(s) as float64 (a number or a list)
    lam_rec: object
    seed: int
    n_shards: int  # shard count of the group that wrote it (provenance)


def _as_list(x):
    return np.asarray(x.detach().cpu().numpy(), np.float64).tolist()


def checkpoint_stream(path: str, pipeline, *, t_next: int,
                      seed: int) -> str:
    """Write a ``StreamCheckpoint`` of ``pipeline``'s price chain, in the
    JAX package's JSON (``t_next``, ``lam``, ``lam_rec``, ``seed``,
    ``n_shards``), atomically (write, then rename).  Every host holds the
    same chain, so any one host's file is the truth."""
    from repro_torch.launch.mesh import mesh_num_shards

    lam = _as_list(pipeline.lam)
    blob = {"t_next": int(t_next), "lam": lam, "lam_rec": lam,
            "seed": int(seed),
            "n_shards": int(mesh_num_shards(pipeline.mesh))}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)
    return path


def restore_stream(path: str, pipeline) -> StreamCheckpoint:
    """Load a ``StreamCheckpoint`` (written by either package) into
    ``pipeline``'s price buffer, in place; the group restoring it may be
    any size.  Returns the checkpoint: resume at ``t_next`` (serving
    ``sizes[t_next:]`` through a ``ShiftedSource``)."""
    with open(path) as f:
        blob = json.load(f)
    saved = np.asarray(blob["lam"], np.float32).reshape(
        tuple(pipeline.lam.shape))
    pipeline.lam.copy_(torch.from_numpy(saved))
    return StreamCheckpoint(
        t_next=int(blob["t_next"]), lam=blob["lam"],
        lam_rec=blob["lam_rec"], seed=int(blob["seed"]),
        n_shards=int(blob["n_shards"]))
