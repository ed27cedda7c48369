"""Run one (architecture x shape) cell of the model zoo on one card.

    python -m repro_torch.launch.cells --arch dlrm-rm2 --shape serve_p99 \\
        [--preset smoke|full] [--calls 3] [--device cpu] [--seed 0]
    python -m repro_torch.launch.cells --arch gemma2-2b \\
        --shape prefill_32k|decode_32k [--preset smoke|full] ...
    python -m repro_torch.launch.cells --arch din --shape train_batch ...
    python -m repro_torch.launch.cells --arch bst \\
        --shape train_batch|serve_p99|serve_bulk|retrieval_cand ...
    python -m repro_torch.launch.cells --arch schnet \\
        --shape full_graph_sm|minibatch_lg|ogb_products|molecule ...
    python -m repro_torch.launch.cells --arch glm4-9b|minicpm-2b \\
        --shape prefill_32k|decode_32k ...
    python -m repro_torch.launch.cells --arch greenflow-cascade \\
        --shape reward_serve|nearline_dual|reward_train|rank_serve ...

builds the cell (``configs.get_arch(arch).make_cell(shape, cfg)``, with
``cfg`` None for the full preset, the module's own full config for the
shape, and ``smoke_config()`` for the smoke preset), draws its
weights and inputs from ``--seed`` on the device, calls it ``--calls``
times and prints, for each call, its synchronised time in ms and the
checksum (sum) of its logits.  It is the single-card counterpart of the
JAX package's ``launch/dryrun.py --arch/--shape`` selection: the cell
runs for real instead of being lowered.

A train cell (DIN's and BST's ``train_batch``, SchNet's four cells,
greenflow-cascade's ``reward_train``) is a train step: each call takes the state the last
one returned and prints its loss instead of a checksum.  A cell that
returns several tensors (greenflow-cascade's ``reward_serve``: the
decisions and the rewards; ``nearline_dual``: the price and its gap
trace) names them in ``meta["outputs"]``; each one's shape and
checksum is printed.

``--preset full`` is the published width (DLRM-RM2's table is 10.0 GB;
gemma2-2b's cells hold 5.2 GB of bf16 weights and a 14.0 GB or 27.9 GB
KV cache, glm4-9b's 18.8 GB and a 5.4 GB or 42.9 GB cache, minicpm-2b's
5.45 GB and 48.3 GB; SchNet's ogb_products trains on 61.9 M edges);
``--preset smoke`` the configs' small widths, at the cell's batch for
the recsys archs, at 2 sequences of 64 positions for the LMs and on a
40-node graph (or a subgraph sampled from a 300-node one) for SchNet.
A cell's logits are (B,) for the recsys archs and the last token's
(B, V) for the LMs.  It
runs on the card unless ``--device cpu`` is given; without a card it
stops with an error.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import registered_shapes
from repro_torch.device import resolve_device


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True,
                    choices=registered_shapes())
    ap.add_argument("--preset", default="full", choices=("smoke", "full"))
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = get_arch(args.arch)
    cell = mod.make_cell(args.shape, cfg=(mod.smoke_config()
                                          if args.preset == "smoke"
                                          else None))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"cell {cell.arch_id} x {cell.shape_name} ({cell.kind}, preset "
          f"{args.preset}) on {name}: {cell.meta['model_flops']:.4e} "
          f"model FLOPs per call")
    t0 = time.perf_counter()
    fargs = cell.make_args(args.seed, device)
    _sync(device)
    print(f"weights and inputs drawn in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (seed {args.seed})")
    for i in range(args.calls):
        _sync(device)
        t0 = time.perf_counter()
        out = cell.fn(*fargs)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        if cell.kind == "train":
            state, loss = out
            fargs = (state, *fargs[1:])
            if not torch.isfinite(loss):
                raise RuntimeError(f"call {i}: the loss is not finite")
            print(f"call {i}: {ms:.3f} ms, step {int(state.step)} loss "
                  f"{float(loss):.6f}")
            continue
        outs = out if isinstance(out, tuple) else (out,)
        names = cell.meta.get("outputs", ("logits",))
        if not all(torch.isfinite(o.float()).all() for o in outs):
            raise RuntimeError(f"call {i}: outputs are not finite")
        print(f"call {i}: {ms:.3f} ms, " + ", ".join(
            f"{name} {tuple(o.shape)} checksum {float(o.double().sum()):.9g}"
            for name, o in zip(names, outs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
