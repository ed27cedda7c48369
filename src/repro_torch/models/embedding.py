"""Embedding helpers.

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
