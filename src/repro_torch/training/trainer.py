"""Train-loop substrate: the train step and the resumable loop.

``build_train_step`` turns any ``loss_fn(params, batch) -> scalar`` into
a (state, batch) -> (state, metrics) step with

  * gradient accumulation over microbatches: microbatch m is the
    contiguous rows [m b, (m + 1) b) of the batch (as the JAX step slices
    them), the gradients and losses averaged over the microbatches;
  * the optional gradient ``compress`` hook, then global-norm clipping;
  * the learning-rate schedule, read at the step before the update.

Gradients come from ``backward`` into detached copies of the
parameters (``micro_value_and_grad``), so the state's parameters never require gradients: a trained
tree can go to scoring and CUDA-graph capture as it is.  A leaf that
does not reach the loss gets a zero gradient, as under ``jax.grad``.

``Trainer`` drives the loop with periodic atomic checkpoints, resume
(``pipeline.seek``) and a preemption hook (SIGTERM -> checkpoint, exit).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import clip_by_global_norm
from repro_torch.tree import leaves, unflatten


@dataclass
class TrainState:
    step: torch.Tensor  # 0-d int32, on the CPU
    params: dict
    opt_state: object


def init_state(params, optimizer) -> TrainState:
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt_state=optimizer.init(params))


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``; both detached.
    ``batch`` is whatever ``loss_fn`` takes."""
    return micro_value_and_grad(loss_fn, params, batch)


def micro_value_and_grad(loss_fn: Callable, params, batch: dict,
                         n_microbatches: int = 1):
    """(loss, gradient tree) over ``n_microbatches`` microbatches, as the
    JAX train steps take them: microbatch m is rows [m b, (m + 1) b) of
    every batch leaf, the loss l_0 / n + l_1 / n + ... (the JAX LM cell's
    order; the JAX trainer's (l_0 + l_1 + ...) / n rounds apart from it
    by an ulp at most) and the gradient (g_0 + g_1 + ...) / n.  The f32
    leaves' gradients accumulate in place (``backward`` into the leaves'
    ``.grad``), so a step holds one gradient tree, not two; the other
    leaves' sum in f32 beside them, as the JAX trainer's f32 accumulator
    does."""
    n = n_microbatches
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten(params, flat)
    rows = next(iter(batch.values())).shape[0] // n if n > 1 else 0
    loss, acc = None, {}
    for m in range(n):
        mb = ({k: v[m * rows:(m + 1) * rows] for k, v in batch.items()}
              if n > 1 else batch)
        with torch.enable_grad():
            l_m = loss_fn(tree, mb)
            l_m.backward()
        l_m = l_m.detach() / n if n > 1 else l_m.detach()
        loss = l_m if loss is None else loss + l_m
        for i, p in enumerate(flat):
            if n > 1 and p.grad is not None and p.dtype != torch.float32:
                g = p.grad.float()
                acc[i] = acc[i] + g if i in acc else g
                p.grad = None
    grads = [acc.get(i, p.grad) if p.grad is not None or i in acc
             else torch.zeros_like(p) for i, p in enumerate(flat)]
    if n > 1:
        grads = [g.div_(n) for g in grads]
    return loss, unflatten(params, grads)


def build_train_step(loss_fn: Callable, optimizer, schedule, *,
                     n_microbatches: int = 1, clip_norm: float = 1.0,
                     compress: Callable | None = None):
    """loss_fn(params, batch) -> scalar; the batch's leading dimension must
    divide by ``n_microbatches``."""

    def step_fn(state: TrainState, batch: dict):
        params = state.params
        loss, grads = micro_value_and_grad(loss_fn, params, batch,
                                           n_microbatches)
        if compress is not None:
            grads = compress(grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(state.step)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               params, lr)
        return (TrainState(state.step + 1, new_params, new_opt),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return step_fn


@dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    keep_ckpts: int = 3
    log_every: int = 50


def batch_to(batch: dict, device) -> dict:
    """A pipeline's batch (numpy arrays or tensors) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    """Checkpointed, resumable, preemption-safe training loop.  Batches go to
    the device of the state's first parameter."""

    def __init__(self, cfg: TrainerConfig, train_step, state, pipeline,
                 *, log_fn: Callable = print):
        self.cfg = cfg
        self.train_step = train_step
        self.state = state
        self.pipeline = pipeline
        self.log_fn = log_fn
        self.metrics_history: list[dict] = []
        self._preempted = False
        self.device = leaves(state.params)[0].device

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def maybe_resume(self):
        if not self.cfg.ckpt_dir:
            return
        step = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if step is not None:
            self.state, _ = ckpt_lib.restore(self.cfg.ckpt_dir, self.state,
                                             step=step)
            self.pipeline.seek(int(step))
            self.log_fn(f"[trainer] resumed from step {step}")

    def _checkpoint(self):
        if self.cfg.ckpt_dir:
            ckpt_lib.save(self.cfg.ckpt_dir, int(self.state.step),
                          self.state, keep=self.cfg.keep_ckpts)

    def run(self) -> dict:
        t0 = time.time()
        start = int(self.state.step)
        for step in range(start, self.cfg.total_steps):
            batch = batch_to(self.pipeline.next(), self.device)
            self.state, metrics = self.train_step(self.state, batch)
            if (step + 1) % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                self.metrics_history.append(m)
                self.log_fn(f"[trainer] step {step+1} "
                            f"loss {m['loss']:.4f} lr {m['lr']:.2e}")
            if (step + 1) % self.cfg.ckpt_every == 0 or self._preempted:
                self._checkpoint()
                if self._preempted:
                    self.log_fn("[trainer] preempted: checkpointed, exiting")
                    break
        self._checkpoint()
        last = self.metrics_history[-1] if self.metrics_history else {}
        return {"wall_s": time.time() - t0, "final": last,
                "history": self.metrics_history}
