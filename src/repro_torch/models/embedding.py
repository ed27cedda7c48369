"""Embedding helpers.

Ragged bags: (ids, segment_ids) pairs, the JAX package's
``embedding_bag`` (a gather and a segment sum or max).  It reaches no
Pallas kernel there, so its plain torch form here is its port.

Fixed-size embedding bags: static (B, L) bags with a pad mask.  The sum
and mean forms are the ``embedding_bag`` kernel (``kernels.ops``): the
mean is its weighted form with weights mask / max(count, 1), so no
(B, L, D) gather is materialised on the card.

Stacked tables (DLRM, xDeepFM): the per-field vocabularies live in one
table, field f at row offset ``stacked_offsets(vocabs)[f]``, so all
fields are one gather.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ops


def embedding_bag(table, ids, segment_ids, num_bags: int, *,
                  mode: str = "sum", per_sample_weights=None):
    """table (V, D); ids (N,); segment_ids (N,) -> (num_bags, D).

    As ``jax.ops.segment_sum``/``segment_max`` do, an empty bag is 0
    under ``sum`` and ``mean`` and -inf under ``max``, and a segment id
    outside [0, num_bags) is dropped: its row goes to a spare bag that is
    cut off, so nothing raises and nothing syncs with the host (unlike
    ``index_add_`` on such an id, or ``F.embedding_bag``, which gives 0
    for an empty max bag and refuses weights with ``max``)."""
    rows = table.index_select(0, ids.long())  # (N, D)
    if per_sample_weights is not None:
        rows = rows * per_sample_weights[:, None]
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < num_bags), seg,
                      torch.full_like(seg, num_bags))
    shape = (num_bags + 1, table.shape[-1])
    if mode == "max":
        out = torch.full(shape, -torch.inf, dtype=rows.dtype,
                         device=rows.device)
        out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows, "amax")
        return out[:num_bags]
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {mode!r}")
    out = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
    out.index_add_(0, seg, rows)
    if mode == "sum":
        return out[:num_bags]
    cnt = torch.zeros(num_bags + 1, dtype=torch.float32, device=rows.device)
    cnt.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float32))
    return out[:num_bags] / torch.clamp(cnt[:num_bags], min=1.0)[:, None]


def fixed_bag(table, ids, mask=None, *, mode: str = "sum"):
    """table (V, D); ids (..., L) -> (..., D). mask (..., L) 1=valid."""
    lead, bag = ids.shape[:-1], ids.shape[-1]
    flat_ids = ids.reshape(-1, bag)
    flat_mask = None if mask is None else mask.reshape(-1, bag)
    if mode == "sum":
        out = ops.embedding_bag(table, flat_ids, flat_mask)
    elif mode == "mean":
        if flat_mask is None:
            w = torch.full(flat_ids.shape, 1.0 / max(bag, 1),
                           dtype=table.dtype, device=table.device)
        else:
            count = flat_mask.sum(dim=-1, keepdim=True)
            w = flat_mask / torch.clamp(count, min=1.0)
        out = ops.embedding_bag(table, flat_ids, w)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out.reshape(*lead, table.shape[-1])


@functools.lru_cache(maxsize=None)
def _offsets(vocab_sizes: tuple, device: torch.device) -> torch.Tensor:
    off = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]])
    return torch.as_tensor(off, dtype=torch.int64, device=device)


def stacked_offsets(vocab_sizes, device=None) -> torch.Tensor:
    """(F,) int64 row offset of each field's sub-table inside the stacked
    table, on ``device`` (made once per device)."""
    return _offsets(tuple(vocab_sizes), torch.device(device or "cpu"))
