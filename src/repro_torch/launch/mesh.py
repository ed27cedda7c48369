"""The serving request mesh.

A ``RequestMesh`` splits every padded window of b requests into S
request shards of b / S rows over P processes (S % P == 0): process p
owns shards [p S / P, (p + 1) S / P), so its rows of every window are one
contiguous block.  The pipeline runs each shard's rows through the same
ops at the same shape wherever the shard lives, so a shard's results do
not depend on P, and every cross-shard sum is a shard-ordered fold
(``distributed.sharding``): at a fixed S, one process and any number of
processes serve bit for bit alike.

``mesh_num_shards`` is the GLOBAL shard count (it keys the pad quantum
and the buckets, so every process pads every window alike);
``mesh_local_shards`` the shards of this process (what sizes the rows it
builds).  ``mesh=None`` everywhere means no mesh: one shard, one process.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RequestMesh:
    """S request shards (the ``distributed.sharding.REQUEST_AXIS``) over a
    group of P processes; this process is ``rank``.  ``group`` is the
    ``torch.distributed`` process group the collectives use (None: the
    default group, or no group when P = 1)."""

    n_shards: int
    rank: int = 0
    world: int = 1
    group: object = None

    def __post_init__(self):
        if self.n_shards < 1 or self.world < 1:
            raise ValueError(f"a request mesh needs >= 1 shard and >= 1 "
                             f"process, got {self.n_shards} and "
                             f"{self.world}")
        if self.n_shards % self.world:
            raise ValueError(f"{self.n_shards} shards do not divide over "
                             f"{self.world} processes")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a group of "
                             f"{self.world}")

    @property
    def local_shards(self) -> int:
        return self.n_shards // self.world

    @property
    def first_shard(self) -> int:
        return self.rank * self.local_shards


def mesh_num_shards(mesh) -> int:
    """GLOBAL shard count of a mesh (1 for ``None``)."""
    return 1 if mesh is None else int(mesh.n_shards)


def mesh_local_shards(mesh) -> int:
    """Shards of ``mesh`` owned by THIS process (1 for ``None``)."""
    return 1 if mesh is None else int(mesh.local_shards)


def process_shard_rows(mesh, b: int) -> list[tuple[int, int]]:
    """Row slices of a b-row window held by THIS process: one ``[lo,
    hi)`` pair a local shard, in shard order (shard s holds rows [s b /
    S, (s + 1) b / S))."""
    n_shards = mesh_num_shards(mesh)
    if b % n_shards:
        raise ValueError(f"b={b} not divisible by {n_shards} shards")
    per = b // n_shards
    first = 0 if mesh is None else mesh.first_shard
    return [(s * per, (s + 1) * per)
            for s in range(first, first + mesh_local_shards(mesh))]


def make_request_mesh(n_shards: int | None = None) -> RequestMesh:
    """The request mesh over this process's group: the group joined by
    ``distributed.multihost.initialize`` (one process without one), with
    ``n_shards`` shards, by default one a process (each process serves
    from one card, or from the CPU).  An explicit ``n_shards``, a
    multiple of the process count, holds S fixed across group sizes."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    n = world if n_shards is None else int(n_shards)
    return RequestMesh(n_shards=n, rank=rank, world=world)
