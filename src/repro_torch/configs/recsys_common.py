"""Shared cell builders for the recsys architecture configs.

All recsys archs expose the same shape set:
  train_batch    B=65,536   train_step (AdamW); DIN's runs, DLRM's and
                            xDeepFM's wait for the backward kernels of
                            dot_interact and cin_layer (ROADMAP queue A
                            item 25)
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
from repro_torch.training.optimizer import AdamW
from repro_torch.training.trainer import (TrainState, init_state,
                                          value_and_grad)

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000,
                           kind="retrieval"),
}
SERVE_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
SKIPPED_SHAPES = {"train_batch": "training waits for the backward "
                                 "kernels of dot_interact and cin_layer "
                                 "(ROADMAP queue A item 25)"}


def check_shape(shape: str, skipped: dict = SKIPPED_SHAPES) -> dict:
    if shape in skipped:
        raise NotImplementedError(f"{shape}: {skipped[shape]}")
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
