"""Optimizers and learning-rate schedules as functional updates over
parameter trees, as the JAX package writes them (``torch.optim`` rounds
AdamW differently and is not used).

Each optimizer is an (init, update) pair:

    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params, lr)

``update`` returns new tensors and leaves its inputs as they are;
``AdamW.update_`` and ``sgd_`` update in place instead, leaf by leaf, for
the train cells whose JAX counterparts donate their state (a step then
holds one leaf's temporaries, not a second copy of the parameters and
moments: 31 GB at gemma2-2b's widths).  The
moments are f32 on the parameters' device; the step count is a 0-d int32
tensor kept on the CPU, so the bias corrections and the schedules cost
the card no sync.  Schedules map a step (a 0-d tensor or an int) to a
0-d f32 CPU tensor lr, computed in f32 as JAX computes them.  WSD
(warmup-stable-decay) is MiniCPM's schedule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.models.layers import global_norm
from repro_torch.tree import leaves, tree_map


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before).  The leaves' f32 squares are summed in JAX's leaf order."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


def _zero_step() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# -- optimizers ---------------------------------------------------------------


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return AdamState(_zero_step(), zeros, tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr):
        """``update_`` on copies: leaves ``state`` and ``params`` as they
        are."""
        return self.update_(grads, AdamState(state.step,
                                             tree_map(torch.clone, state.mu),
                                             tree_map(torch.clone, state.nu)),
                            tree_map(torch.clone, params), lr)

    @torch.no_grad()
    def update_(self, grads, state: AdamState, params, lr):
        """Overwrites the moments in ``state`` and the parameters in
        ``params`` (returned, with the new state), one leaf at a time."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        c1 = 1 - torch.pow(_f32(b1), step.float())
        c2 = 1 - torch.pow(_f32(b2), step.float())
        lr = _f32(lr)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.mu), leaves(state.nu)):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        return params, AdamState(step, state.mu, state.nu)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: dict


@dataclass(frozen=True)
class SGD:
    momentum: float = 0.9
    nesterov: bool = False

    def init(self, params) -> SGDState:
        return SGDState(_zero_step(), tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params, lr):
        m = tree_map(lambda b, g: self.momentum * b + g.float(),
                     state.momentum, grads)
        eff = (tree_map(lambda b, g: self.momentum * b + g.float(), m, grads)
               if self.nesterov else m)
        lr = _f32(lr)
        new = tree_map(lambda p, u: (p.float() - lr * u).to(p.dtype), params,
                       eff)
        return new, SGDState(state.step + 1, m)


@torch.no_grad()
def sgd_(grads, params, lr: float):
    """Stateless SGD in place, as the JAX hybrid cells write it for the
    embedding tables: p <- (p - (lr g in p's dtype)) in p's dtype, each
    product and difference rounded to p's dtype.  Overwrites ``params``
    and the gradients (``grads`` holds lr g after)."""
    for p, g in zip(leaves(params), leaves(grads)):
        p.sub_(g.to(p.dtype).mul_(lr))


# -- schedules ----------------------------------------------------------------


def constant_schedule(lr: float) -> Callable:
    return lambda step: _f32(lr)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable:
    """Linear warmup from 0 (so step 0's lr is 0 when ``warmup`` > 0),
    then a cosine from ``peak`` to ``floor`` at ``total``."""
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return fn


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.1) -> Callable:
    """Warmup-Stable-Decay (MiniCPM, [arXiv:2404.06395] §4): linear
    warmup, a constant plateau, then a decay to ``floor_frac * peak``."""
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(1, warmup)
        t = torch.clamp((step - warmup - stable) / max(1, decay), 0.0, 1.0)
        dec = peak * torch.pow(_f32(floor_frac), t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, _f32(peak),
                                       dec))

    return fn
