"""Optimizers and learning-rate schedules as functional updates over
parameter trees, as the JAX package writes them (``torch.optim`` rounds
AdamW differently and is not used).

Each optimizer is an (init, update) pair:

    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params, lr)

``update`` returns new tensors and leaves its inputs as they are.  The
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
from repro_torch.tree import tree_map


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
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                      grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state.nu, grads)
        c1 = 1 - torch.pow(_f32(b1), step.float())
        c2 = 1 - torch.pow(_f32(b2), step.float())
        lr = _f32(lr)

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamState(step, mu, nu)


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
