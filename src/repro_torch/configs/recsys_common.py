"""Shared cell builders for the recsys architecture configs.

All recsys archs expose the same shape set:
  train_batch    B=65,536   train_step: AdamW (DIN, BST), or the hybrid
                            optimizer (DLRM, xDeepFM: SGD on the
                            embedding tables, AdamW on the rest)
  serve_p99      B=512      online-inference forward
  serve_bulk     B=262,144  offline-scoring forward
  retrieval_cand B=1 user x 1,000,000 candidates
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamW, sgd_
from repro_torch.training.trainer import (TrainState, init_state,
                                          value_and_grad)

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000,
                           kind="retrieval"),
}
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def check_shape(shape: str) -> dict:
    if shape not in RECSYS_SHAPES:
        raise KeyError(f"unknown shape {shape!r}; have "
                       f"{sorted(RECSYS_SHAPES)}")
    return RECSYS_SHAPES[shape]


def sparse_ids(rng: np.random.Generator, vocab_sizes, n: int) -> np.ndarray:
    """(n, len(vocab_sizes)) ids, field f uniform in [0, vocab_sizes[f])."""
    return rng.integers(0, np.asarray(vocab_sizes), (n, len(vocab_sizes))
                        ).astype(np.int32)


def on(device, **arrays) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def make_cell(arch_id: str, shape: str, *, kind: str, fn: Callable,
              make_params: Callable, make_inputs: Callable,
              flops_fwd: float) -> Cell:
    """A cell whose args are (params, *inputs): params from
    ``make_params(gen, device)``, inputs from ``make_inputs(rng,
    device)``, both seeded by ``seed``.  ``fn`` runs without autograd."""

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        params = make_params(torch.Generator().manual_seed(seed), device)
        return (params, *make_inputs(np.random.default_rng(seed), device))

    return Cell(arch_id=arch_id, shape_name=shape, kind=kind,
                fn=torch.no_grad()(fn), make_args=make_args,
                meta={"model_flops": flops_fwd})


def train_cell(arch_id: str, shape: str, *, loss_fn: Callable,
               make_params: Callable, make_batch: Callable,
               flops_fwd: float, lr: float = 1e-3) -> Cell:
    """The JAX cell's train step: the gradient of ``loss_fn(params,
    batch)`` and one AdamW update (no weight decay, constant ``lr``, no
    clipping).  ``fn(state, batch) -> (state, loss)``; ``make_args(seed,
    device)`` -> (a fresh ``TrainState`` of ``make_params(gen, device)``,
    ``make_batch(rng, device)``).  ``model_flops`` counts forward and
    backward as 3 x the forward."""
    opt = AdamW(weight_decay=0.0)

    def step(state: TrainState, batch: dict):
        loss, grads = value_and_grad(loss_fn, state.params, batch)
        new_params, new_opt = opt.update(grads, state.opt_state,
                                         state.params, lr)
        return TrainState(state.step + 1, new_params, new_opt), loss

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        params = make_params(torch.Generator().manual_seed(seed), device)
        return (init_state(params, opt),
                make_batch(np.random.default_rng(seed), device))

    return Cell(arch_id=arch_id, shape_name=shape, kind="train", fn=step,
                make_args=make_args, meta={"model_flops": 3.0 * flops_fwd})


# the JAX DLRM and xDeepFM cells' hybrid optimizer: SGD on the tables,
# AdamW on the dense leaves
HYBRID_EMB_LR, HYBRID_LR = 0.04, 1e-3


def hybrid_train_cell(arch_id: str, shape: str, *, loss_fn: Callable,
                      make_params: Callable, make_batch: Callable,
                      flops_fwd: float, emb_keys: tuple) -> Cell:
    """The JAX DLRM and xDeepFM cells' step with the hybrid optimizer:
    the gradient of ``loss_fn(params, batch)``, stateless SGD at
    ``HYBRID_EMB_LR`` on the leaves under ``emb_keys`` (the embedding
    tables, in their storage dtype, ``optimizer.sgd_``) and AdamW (no
    weight decay, ``HYBRID_LR``, no clipping) on the rest, the dense
    leaves, whose moments are the whole optimizer state.
    ``fn(state, batch) -> (state, loss)`` updates the state in place (the
    JAX cell donates it: the DLRM table and its gradient are 10 GB each in
    bf16).  ``model_flops`` counts
    forward and backward as 3 x the forward."""
    opt = AdamW(weight_decay=0.0)

    def split(tree):
        return ({k: v for k, v in tree.items() if k in emb_keys},
                {k: v for k, v in tree.items() if k not in emb_keys})

    def step(state: TrainState, batch: dict):
        loss, grads = value_and_grad(loss_fn, state.params, batch)
        g_emb, g_dense = split(grads)
        p_emb, p_dense = split(state.params)
        del grads
        sgd_(g_emb, p_emb, HYBRID_EMB_LR)
        _, opt_state = opt.update_(g_dense, state.opt_state, p_dense,
                                   HYBRID_LR)
        return TrainState(state.step + 1, state.params, opt_state), loss

    def make_args(seed: int, device=None):
        device = resolve_device(device)
        params = make_params(torch.Generator().manual_seed(seed), device)
        state = TrainState(torch.zeros((), dtype=torch.int32), params,
                           opt.init(split(params)[1]))
        return state, make_batch(np.random.default_rng(seed), device)

    return Cell(arch_id=arch_id, shape_name=shape, kind="train", fn=step,
                make_args=make_args,
                meta={"model_flops": 3.0 * flops_fwd,
                      "optimizer": f"hybrid: sgd {HYBRID_EMB_LR} on "
                                   f"{', '.join(emb_keys)}, adamw "
                                   f"{HYBRID_LR} on the dense leaves"})
