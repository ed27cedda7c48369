"""Generic training entry point.

    python -m repro_torch.launch.train --arch din --steps 300
    python -m repro_torch.launch.train --arch din --preset smoke \\
        --steps 50 --ckpt-dir /tmp/ck --resume [--device cpu]

Selects the arch from the registry, builds its deterministic batch
pipeline and drives ``training.trainer.Trainer`` (checkpoints, resume,
SIGTERM preemption) with the JAX CLI's flags.  ``--preset smoke``
(default) trains the reduced config; ``--preset full`` the published
one.  Every arch trains through its ``smoke_loss`` (din, dlrm-rm2,
xdeepfm, bst, schnet, gemma2-2b, glm4-9b, minicpm-2b,
granite-moe-1b-a400m, olmoe-1b-7b, greenflow-cascade).  It runs on the
card unless ``--device cpu`` is given; without a card it stops with an
error.
Weights are drawn from ``--seed`` by the port's own inits.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.pipeline import DeterministicPipeline
from repro_torch.device import resolve_device
from repro_torch.models.layers import count_params
from repro_torch.training.optimizer import (AdamW, cosine_schedule,
                                            wsd_schedule)
from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                          build_train_step, init_state)

def make_pipeline(mod, cfg, global_batch: int, seed: int):
    """The arch's smoke batches as NumPy arrays; the batch a step draws is
    a function of (seed, step) alone."""
    def fn(rng, step, lo, hi):
        b = mod.smoke_batch(rng, cfg)
        return {k: v.numpy() for k, v in b.items()}

    return DeterministicPipeline(fn, global_batch, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--preset", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", choices=("cosine", "wsd"), default="cosine")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.preset == "smoke" else mod.full_config()
    params = mod.init_smoke(torch.Generator().manual_seed(args.seed), cfg,
                            device)
    print(f"[train] arch={args.arch} preset={args.preset} "
          f"params={count_params(params)/1e6:.2f}M steps={args.steps} "
          f"device={device}")

    opt = AdamW(weight_decay=0.01)
    if args.schedule == "wsd":
        sched = wsd_schedule(args.lr, warmup=args.steps // 10,
                             stable=int(args.steps * 0.7),
                             decay=args.steps // 5)
    else:
        sched = cosine_schedule(args.lr, warmup=args.steps // 10,
                                total=args.steps)
    step = build_train_step(lambda p, b: mod.smoke_loss(p, cfg, b), opt,
                            sched, n_microbatches=args.microbatches)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      log_every=max(1, args.steps // 10)),
        step, init_state(params, opt),
        make_pipeline(mod, cfg, args.batch, args.seed))
    trainer.install_preemption_handler()
    if args.resume:
        trainer.maybe_resume()
    out = trainer.run()
    final = out["final"]
    print(f"[train] done in {out['wall_s']:.1f}s "
          f"final_loss={final.get('loss', float('nan')):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
