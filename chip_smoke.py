#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # one card, from the repository root

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the three CUDA kernels and their PyTorch binding from
     ``src/repro_torch/kernels/csrc`` with ``torch.utils.cpp_extension``
     (ninja compiles the sources in parallel);
  3. holds every kernel against its plain-torch version on the card, at
     small shapes and at the serving path's full widths (truncation
     exact, target attention 2e-5, embedding bag 1e-5) and times both,
     with the least time the card could take (``bound_ms``) and, where
     one PyTorch call computes the same function, that call's time;
  4. serves full-width ``GeneratedSource`` windows through
     ``repro_torch.launch.serve`` (100k-user world, 4000-item corpus,
     paper chains, stage and reward models at full width, random
     weights from the seed) with the kernel launch counters reset just
     before and read just after; checks the budget, the price, the
     revenue, that every kernel launched, that the device tables served
     in window 0 equal the NumPy host builder on the same stage scores
     and that its revenue equals the plain truncation on those tables;
  5. profiles one more full-width window under ``torch.profiler`` and
     prints its wall time, the device's busy time and idle share, each
     phase range's host and device span, and the operators that took the
     most device time;
  6. serves a small world on the card and on the CPU from the same seed
     and holds the two runs' decisions and prices against each other;
  7. prints the ``kernels`` JSON line, the card line and, last, the
     ``{"ok": true, ...}`` line.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device, or without the repository's ``src/``
beside it, it fails before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, *, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def close(got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    import torch
    torch.cuda.synchronize()
    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} values beyond tol {tol} "
                             f"(max abs err {float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


# -- phase 3: kernels against their plain versions --------------------------


def truncation_inputs(g_n, u_n, cap, b_n, n3_choices, gen, dev):
    import torch
    count = torch.randint(cap // 2, cap + 1, (g_n, u_n, 1), generator=gen)
    perm = torch.argsort(torch.rand(g_n, u_n, cap, generator=gen), dim=-1)
    p = torch.where(perm < count, perm, torch.full_like(perm, cap))
    ck = (torch.rand(g_n, u_n, cap, generator=gen) < 0.15).float()
    groups = torch.randint(0, g_n, (b_n,), generator=gen)
    rows = torch.arange(b_n) % u_n
    n3 = torch.as_tensor(n3_choices)[
        torch.randint(0, len(n3_choices), (b_n,), generator=gen)]
    return [x.to(dev) for x in (p.int(), ck, groups.int(), rows.int(),
                                n3.int())]


def check_truncation(gen, dev, layout, expose):
    import torch
    from repro_torch.kernels import ops, ref

    small = truncation_inputs(3, 5, 40, 32, [1, 7, 20, 40], gen, dev)
    close(ops.cascade_truncate(*small, expose=6),
          ref.cascade_truncate_ref(*small, expose=6), 0.0)
    g_n, cap = layout.p_sorted.shape[0], layout.cap
    full = truncation_inputs(g_n, 512, cap, 512,
                             sorted(set(layout.n3_of_chain.tolist())),
                             gen, dev)
    got = ops.cascade_truncate(*full, expose=expose)
    want = ref.cascade_truncate_ref(*full, expose=expose)
    if not torch.equal(got, want):
        raise AssertionError("truncation kernel differs from its plain "
                             "version")
    err = close(got, want, 0.0)
    ms = cuda_ms(lambda: ops.cascade_truncate(*full, expose=expose),
                 reps=200)
    plain_ms = cuda_ms(lambda: ref.cascade_truncate_ref(*full,
                                                        expose=expose),
                       reps=50)
    # what the data needs: each request's row up to its expose-th
    # survivor (the kernel stops there), plus indices and the output
    p, ck, groups, rows, n3 = full
    m = p[groups.long(), rows.long()] < n3[:, None]
    q = torch.cumsum(m.int(), dim=1)
    need = torch.clamp((q < expose).sum(dim=1) + 1, max=cap)
    nbytes = float(need.sum()) * 8 + groups.numel() * 16
    ops_n = float(need.sum()) * 4
    b_ms, by = bound(nbytes, ops_n)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"G={g_n} U=512 C={cap} B=512 expose={expose}"}


def check_target_attention(gen, dev, hist_mask):
    import torch
    from repro_torch.kernels import ops, ref

    def inputs(b, n, t, d, h1, h2, mask=None, shared=False):
        def r(*s, scale=1.0):
            return (scale * torch.randn(*s, generator=gen)).to(dev)
        qn = r(n, d, scale=0.3)
        q = qn[None].expand(b, n, d) if shared else r(b, n, d, scale=0.3)
        keys = r(b, t, d, scale=0.3)
        if mask is None:
            mask = (torch.rand(b, t, generator=gen) > 0.3).float().to(dev)
        ws = []
        for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
            ws += [r(di, do, scale=di ** -0.5), r(do, scale=0.1)]
        return (q, keys, mask, *ws)

    for args in (inputs(3, 5, 7, 8, 12, 6), inputs(2, 130, 9, 36, 80, 40),
                 inputs(4, 1, 100, 36, 80, 40)):
        close(ops.target_attention(*args), ref.target_attention_ref(*args),
              2e-5)
    b, n, t = hist_mask.shape[0], 256, hist_mask.shape[1]
    d, h1, h2 = 36, 80, 40
    full = inputs(b, n, t, d, h1, h2, mask=hist_mask, shared=True)
    err = close(ops.target_attention(*full),
                ref.target_attention_ref(*full), 2e-5)
    ms = cuda_ms(lambda: ops.target_attention(*full), reps=10)
    plain_ms = cuda_ms(lambda: ref.target_attention_ref(*full), reps=3,
                       warm=1)
    # The function's least work: with W1's row blocks Wq, Wk, Wd, Wp for
    # q, k, q-k and q*k, feat W1 = q (Wq + Wd) + k (Wk - Wd) + (q*k) Wp.
    # The first term is needed once per distinct candidate, the second
    # once per unmasked (user, step); only (q*k) Wp, the sum of the
    # terms, W2, W3 and the pooling are needed per unmasked (candidate,
    # step).
    user_steps = float((hist_mask != 0).sum())
    steps = user_steps * n  # unmasked (b, n, t)
    cands = n if full[0].stride(0) == 0 else b * n
    per_step = d + 2 * d * h1 + 2 * h1 + 2 * h1 * h2 + 2 * h2 + 2 * d
    ops_n = steps * per_step + (cands + user_steps) * 2 * d * h1
    nbytes = 4 * (n * d + b * t * d + b * t + 4 * d * h1 + h1 * h2
                  + h1 + 2 * h2 + 1 + b * n * d)
    b_ms, by = bound(nbytes, ops_n)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"B={b} N={n} T={t} d={d} h1={h1} h2={h2}"}


def check_embedding_bag(gen, dev, hist_ids, hist_mask, n_items, dim):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    table_s = torch.randn(50, 20, generator=gen).to(dev)
    ids_s = torch.randint(0, 50, (7, 9), generator=gen).to(dev)
    w_s = torch.rand(7, 9, generator=gen).to(dev)
    for w in (w_s, None):
        close(ops.embedding_bag(table_s, ids_s, w),
              ref.embedding_bag_ref(table_s, ids_s, w), 1e-5)
    table = (0.02 * torch.randn(n_items, dim, generator=gen)).to(dev)
    w = hist_mask / torch.clamp(hist_mask.sum(-1, keepdim=True), min=1.0)
    args = (table, hist_ids, w)
    err = close(ops.embedding_bag(*args), ref.embedding_bag_ref(*args),
                1e-5)
    ms = cuda_ms(lambda: ops.embedding_bag(*args), reps=200)
    plain_ms = cuda_ms(lambda: ref.embedding_bag_ref(*args), reps=50)
    lib_ms = cuda_ms(lambda: F.embedding_bag(hist_ids, table, mode="sum",
                                             per_sample_weights=w),
                     reps=200)
    nnz = float((w != 0).sum())
    b, bag = hist_ids.shape
    nbytes = nnz * dim * 4 + b * bag * 8 + b * dim * 4
    b_ms, by = bound(nbytes, 2 * nnz * dim)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "shape": f"V={n_items} D={dim} B={b} L={bag}"}


# -- phase 4: the serving path at full width --------------------------------


def check_window(stack, chunk, res):
    """The served window: its device tables equal the NumPy host builder
    on the same stage scores of its users, and its revenue equals the
    plain truncation on those tables."""
    import numpy as np
    import torch
    from repro_torch.cascade.engine import _compact_group_tables, _user_batch
    from repro_torch.kernels import ref

    src = stack.source
    users = chunk.users
    m = len(users)
    if m > src.chunk:
        raise AssertionError(f"window of {m} users spans several scoring "
                             f"chunks of {src.chunk}")
    slab = src.world.user_slab(users)
    ub = _user_batch(slab, np.arange(m), stack.device, pad_to=src.chunk)
    with torch.no_grad():
        scores = src.score_slab(ub)
    clicks = src.world.clicks_slab(users, slab, pad_rows=src.chunk)
    p_host, ck_host, _ = _compact_group_tables(
        {k: v[:m].cpu().numpy() for k, v in scores.items()}, src._lay,
        clicks[:m], expose=src.expose)
    if not (np.array_equal(chunk.tables["p"].cpu().numpy(),
                           p_host.astype(np.int32))
            and np.array_equal(chunk.tables["ck"].cpu().numpy(),
                               ck_host.astype(np.float32))):
        raise AssertionError("served device tables differ from the host "
                             "builder")
    pipe = stack.pipeline
    p, ck = pipe._pad_chunk_tables(chunk.tables, res.n_valid,
                                   len(res.valid))
    dec = res.decisions.long().cpu()
    rows = torch.arange(len(res.valid)) * torch.from_numpy(
        res.valid > 0).long()
    want = ref.cascade_truncate_ref(
        p.cpu(), ck.cpu(), pipe._g_of.cpu()[dec], rows,
        pipe._n3_of.cpu()[dec], expose=pipe._expose) * torch.from_numpy(
            res.valid)
    if not torch.equal(res.revenue.cpu(), want):
        raise AssertionError("served revenue differs from the plain "
                             "truncation on the same tables")


def serve_full(args):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.stream import window_table

    log(f"cut: {args.windows} windows x {args.requests} requests (a "
        f"serving day has many more); weights random from seed "
        f"{args.seed} (no trained weights in the repository)")
    t0 = time.perf_counter()
    stack = serve.build_stack(users=100_000, requests=args.requests,
                              windows=args.windows, seed=args.seed,
                              device="cuda")
    log(f"stack built in {time.perf_counter() - t0:.1f}s: budget "
        f"{stack.budget:.4e} FLOPs/window, c_max {stack.c_max:.4e}")
    served = {}
    produce = stack.source.window

    def window(t, n):  # keep window 0 as it was served, to check it
        chunk = produce(t, n)
        if t == 0:
            served[0] = chunk
        return chunk

    stack.source.window = window
    torch.cuda.synchronize()
    ops.reset_launches()
    st = serve.serve(stack, sync=True)
    launches = dict(ops.LAUNCHES)
    del stack.source.window
    for line in window_table(st):
        log(line)
    log(f"main-path launches over {len(st.windows)} windows: {launches}")
    for t, r in enumerate(st.windows):
        spend, lam = float(r.spend), float(r.lam_after)
        rev = float(r.revenue_np.sum())
        if not spend <= r.budget + stack.c_max:
            raise AssertionError(f"window {t}: spend {spend} over budget "
                                 f"{r.budget} + c_max")
        if not math.isfinite(lam):
            raise AssertionError(f"window {t}: lambda {lam} not finite")
        if not rev > 0:
            raise AssertionError(f"window {t}: revenue {rev} not > 0")
        if r.decisions.shape != (len(r.valid),):
            raise AssertionError(f"window {t}: decisions shape")
    for name, cnt in launches.items():
        if cnt < 1:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    check_window(stack, served[0], st.windows[0])
    log("window 0 as served: device tables == host builder, revenue == "
        "plain truncation")
    return stack, st, launches


def profile_window(stack) -> None:
    """One more full-width window (produce + serve) under torch.profiler:
    device time per kernel, the host and device span of each phase
    range, and the device's idle share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = stack.sizes[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk = stack.source.window(1000, n)
        stack.pipeline.serve_window(chunk.ctx, chunk.rows,
                                    tables=chunk.tables, update_lam=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device busy: the table's "Self CUDA time total" - kernels, copies
    # and sets, not the annotation ranges (one stream, so no overlap)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    spans: dict = {}
    for e in prof.events():
        if e.name.split("/")[0] in ("world", "score", "tables", "window"):
            side = "device" if e.device_type == DeviceType.CUDA else "host"
            spans.setdefault(e.name, {"host": 0.0, "device": 0.0})
            spans[e.name][side] += e.time_range.elapsed_us() / 1e3
    order = sorted(spans.items(), key=lambda kv: -kv[1]["host"])
    log(f"profiled window: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f})")
    for k, v in order:
        log(f"  range {k}: host span {v['host']:.3f} ms, device span "
            f"{v['device']:.3f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15), flush=True)


def small_parity(seed: int):
    """The same small stack on the card and on the CPU (plain versions):
    decisions agree on >= 99.5% of requests, prices within 1e-3."""
    import numpy as np
    from repro_torch.launch import serve

    runs = []
    for dev in ("cuda", "cpu"):
        stack = serve.build_stack(users=20_000, requests=128, windows=3,
                                  seed=seed, small=True, device=dev)
        runs.append(serve.serve(stack))
    agree, total = 0, 0
    for a, b in zip(*(r.windows for r in runs)):
        agree += int((a.decisions_np == b.decisions_np).sum())
        total += len(a.decisions_np)
        la, lb = float(a.lam_after), float(b.lam_after)
        if abs(la - lb) > 1e-3 * max(abs(lb), 1e-12):
            raise AssertionError(f"price {la} (card) vs {lb} (cpu)")
    rate = agree / total
    if rate < 0.995:
        raise AssertionError(f"card/cpu decisions agree on {rate:.4f}")
    rev = [float(np.sum([w.revenue_np.sum() for w in r.windows]))
           for r in runs]
    log(f"small world card vs cpu: decisions agree {rate:.4f}, revenue "
        f"{rev[0]:.0f} vs {rev[1]:.0f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.cascade.engine import build_compact_layout
    from repro_torch.data.synthetic import StreamingWorld
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s "
        f"(torch.utils.cpp_extension, into {build.build_dir()})")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    wcfg = serve.world_config(512, seed=args.seed)
    # the main path's history bags: a real slab of the full-width world
    slab = StreamingWorld.build(wcfg).user_slab(np.arange(512))
    hist_ids = torch.from_numpy(slab.hist_ids).int().to(dev)
    hist_mask = torch.from_numpy(slab.hist_mask).to(dev)
    chains = serve.build_chains(wcfg, serve.FULL_EXPOSE)
    layout = build_compact_layout(chains, n_items=wcfg.n_items,
                                  expose=serve.FULL_EXPOSE)
    results = {
        "cascade_truncate": check_truncation(gen, dev, layout,
                                             serve.FULL_EXPOSE),
        "target_attention": check_target_attention(gen, dev, hist_mask),
        "embedding_bag": check_embedding_bag(gen, dev, hist_ids, hist_mask,
                                             wcfg.n_items, 32),
    }
    for name, r in results.items():
        log(f"{name} [{r['shape']}]: max_abs_err {r['max_abs_err']:.3e}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    stack, st, launches = serve_full(args)
    n_windows = len(st.windows)
    profile_window(stack)
    small_parity(args.seed)

    src = "src/repro_torch/kernels/csrc/{}.cu"
    tpu = "src/repro/kernels/{}"
    replaces = {"cascade_truncate": tpu.format("cascade_truncate.py:34"),
                "target_attention": tpu.format("target_attention.py:46"),
                "embedding_bag": tpu.format("embedding_bag.py:24")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src.format(name),
         "replaces": replaces[name], "launches": int(launches[name]),
         "launches_per_window": launches[name] / n_windows,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "shape": r["shape"]}
        for name, r in results.items()]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
