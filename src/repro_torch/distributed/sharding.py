"""Shard-ordered sums over the serving request axis.

A window of b padded requests splits into S request shards of b / S
rows, shard s holding rows [s b / S, (s + 1) b / S).  Every sum that
crosses shards is formed as the JAX package's sharded pass forms it: a
partial per shard, computed by the same op on that shard's slice, then
folded in shard order, ((s0 + s1) + s2) + ...  The fold's association
is fixed, so a sum comes out bit for bit the same whichever process
holds which shards and whatever the process count, as long as S is the
same.  One shard is no sharding: every helper then runs the unsharded
op itself, so a one-shard mesh serves exactly as no mesh.

  * ``gather_shards``         - this process's shards' rows -> every
    shard's, in shard order, through the host where the mesh spans
    processes (the pipeline's rewards gather);
  * ``ordered_psum``          - per-shard partials -> their fold, first
    gathering the partials of every process where the mesh spans several;
  * ``exclusive_shard_offset`` - per-shard totals -> the fold of the
    totals of the shards before each one (the guard's prefix offsets);
  * ``shard_sum`` / ``shard_prefix`` - a (b, ...) tensor's sum and
    inclusive prefix sum over its rows, through the two above.
"""
from __future__ import annotations

import torch

# The serving request axis: one name, shared by the mesh and the pipeline.
REQUEST_AXIS = "req"


def _fold(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def gather_shards(partials, mesh=None, *, host=None, every=None,
                  out=None):
    """(n_local, ...) rows of this process's shards -> the (P n_local,
    ...) rows of every process's shards, in shard order (a process's
    shards are contiguous, so process order is shard order).  Across
    processes the rows travel through the host over the mesh's process
    group (a gloo group takes CPU tensors, never CUDA ones): a copy to
    the host, which waits for the device, an all-gather and a copy back.
    ``host`` (shaped like ``partials``), ``every`` ((P,) + that shape)
    and ``out`` (the result, on ``partials``' device) are optional
    buffers for a caller that gathers again and again; pinned host
    buffers make the copy back asynchronous.  On one process the rows
    come back as they are (copied into ``out`` if given)."""
    if mesh is None or mesh.world == 1:
        return partials if out is None else out.copy_(partials)
    import torch.distributed as dist

    shape = tuple(partials.shape)
    if host is None:
        host = torch.empty(shape, dtype=partials.dtype)
    if every is None:
        every = torch.empty((mesh.world,) + shape, dtype=partials.dtype)
    host.copy_(partials.detach())  # waits for the device
    dist.all_gather(list(every.unbind(0)), host, group=mesh.group)
    rows = every.view((-1,) + shape[1:])
    if out is None:
        return rows.to(partials.device)
    return out.copy_(rows, non_blocking=True)


def ordered_psum(partials, mesh=None):
    """(S_local, ...) per-shard partials -> their sum folded in shard
    order (every shard's, gathered first where ``mesh`` spans
    processes)."""
    return _fold(list(gather_shards(partials, mesh).unbind(0)))


def exclusive_shard_offset(totals):
    """(S, ...) per-shard totals -> (S, ...) offsets: row s is the
    ordered fold of totals[0..s-1] (zero for shard 0).  Works for scalar
    totals and (K,) vector totals alike."""
    rows = list(totals.unbind(0))
    outs = [torch.zeros_like(rows[0])]
    for s in range(1, len(rows)):
        outs.append(rows[0] if s == 1 else outs[-1] + rows[s - 1])
    return torch.stack(outs)


def shard_sum(x, n_shards: int = 1):
    """Sum of ``x`` over its rows (the whole tensor for a 1-D ``x``): the
    ordered fold of the S per-shard sums, or ``torch.sum(x)`` itself for
    one shard."""
    if n_shards == 1:
        return torch.sum(x)
    return ordered_psum(torch.sum(x.reshape(n_shards, -1), dim=1))


def shard_prefix(x, n_shards: int = 1):
    """Inclusive prefix sum of a 1-D ``x`` and its total: per-shard
    cumsums plus each shard's exclusive offset, the total the ordered
    fold of the shard totals.  One shard: ``torch.cumsum`` and its last
    entry."""
    if n_shards == 1:
        prefix = torch.cumsum(x, dim=0)
        return prefix, (prefix[-1] if x.shape[0] else torch.sum(x))
    local = torch.cumsum(x.reshape(n_shards, -1), dim=1)
    totals = local[:, -1]
    offsets = exclusive_shard_offset(totals)
    return ((local + offsets[:, None]).reshape(-1),
            ordered_psum(totals))
