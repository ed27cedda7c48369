#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # one card, from the repository root

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the five CUDA kernels and their PyTorch binding from
     ``src/repro_torch/kernels/csrc`` with ``torch.utils.cpp_extension``
     (ninja compiles the sources in parallel);
  3. holds every kernel against its plain-torch version on the card, at
     small shapes and at its path's full widths (truncation exact,
     target attention 2e-5, embedding bag 1e-5, dot interaction 2e-5 in
     f32 and 2e-2 in bf16, CIN 1e-4) and times both, with the least time
     the card could take (``bound_ms``) and the time of the PyTorch
     call(s) that compute the same function (for dot interaction and
     CIN a composition of calls: bmm and a gather, two einsums);
  4. serves full-width ``GeneratedSource`` windows through
     ``repro_torch.launch.serve`` (100k-user world, 4000-item corpus,
     paper chains, stage and reward models at full width, random
     weights from the seed) with the kernel launch counters reset just
     before and read just after; checks the budget, the price, the
     revenue, that the window's three kernels launched (and no other),
     that the device tables served in window 0 equal the NumPy host
     builder on the same stage scores and that its revenue equals the
     plain truncation on those tables;
  5. profiles one more full-width window under ``torch.profiler`` and
     prints its wall time, the device's busy time and idle share, each
     phase range's host and device span, and the operators that took the
     most device time;
  6. serves the model zoo's ``dlrm-rm2`` and ``xdeepfm`` cells at
     ``full_config()`` through ``configs.get_arch(...).make_cell(...)``:
     serve_p99 (B = 512) x 10, serve_bulk (B = 262,144) x 2 and
     retrieval_cand (1 user x 1,000,000 candidates) x 1, each after one
     warm call, with the counters reset before and read after each cell
     (dot_interact once per DLRM forward, cin_layer three times per
     xDeepFM forward); checks finite logits, prints each call's ms and
     the peak memory, and holds retrieval_forward against forward on
     the broadcast batch;
  7. serves a small world on the card and on the CPU from the same seed
     and holds the two runs' decisions and prices against each other;
     runs smoke_config DLRM and xDeepFM from one seed on both and holds
     their logits against each other;
  8. prints the ``kernels`` JSON line, the card line and, last, the
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
PEAK_BF16_S = 989e12  # H100 SXM bf16 tensor cores, dense


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


def bound(nbytes: float, ops: float,
          peak_ops: float = PEAK_F32_S) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` and doing ``ops`` at the
    peak rate of the inputs' type, and which of the two bounds it."""
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / peak_ops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def close(got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|.
    Computed in f64 on the tensors' device."""
    import torch
    torch.cuda.synchronize()
    got, want = got.double(), want.double()
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


def check_dot_interact(dev):
    """Small shapes, then DLRM-RM2's (B, 27, 64) at B = 512 and 262,144 in
    f32 and bf16.  The kernel line reports the serve_bulk bf16 case."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(11)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def feats(b, f, d, dtype):
        x = 0.3 * torch.randn(b, f, d, generator=gen, device=dev)
        return x.to(dtype)

    for b, f, d in ((7, 13, 32), (5, 27, 63), (32, 27, 64)):
        for dt, tol in tols.items():
            x = feats(b, f, d, dt)
            close(ops.dot_interact(x).float(), ref.dot_interact_ref(x).float(),
                  tol)
    rows = {}
    for b in (512, 262_144):
        for dt, tol in tols.items():
            x = feats(b, 27, 64, dt)
            err = close(ops.dot_interact(x).float(),
                        ref.dot_interact_ref(x).float(), tol)
            reps = 200 if b == 512 else 20
            ms = cuda_ms(lambda: ops.dot_interact(x), reps=reps)
            plain_ms = cuda_ms(lambda: ref.dot_interact_ref(x),
                               reps=max(2, reps // 4))
            iu, ju = torch.tril_indices(27, 27, offset=-1, device=dev)
            lib_ms = cuda_ms(lambda: torch.bmm(x, x.mT)[:, iu, ju],
                             reps=max(2, reps // 4))
            esize = x.element_size()
            p = 27 * 26 // 2
            b_ms, by = bound(b * 27 * 64 * esize + b * p * esize,
                             2.0 * b * p * 64,
                             PEAK_BF16_S if dt == torch.bfloat16
                             else PEAK_F32_S)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            rows[(b, name)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                "shape": f"B={b} F=27 D=64 {name}"}
            del x
    for r in rows.values():
        log(f"dot_interact [{r['shape']}]: max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bmm + tril gather {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return rows[(262_144, "bf16")]


def check_cin(dev):
    """Small shapes, then xDeepFM's layers 1 (Hp = 39) and 2 (Hp = 200)
    at m = 39, D = 10, H_out = 200, at B = 512 and 4,096 (the first rows
    of a bulk batch).  The kernel line reports layer 2 at B = 4,096."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(12)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    for b, hp, m, d, ho in ((5, 8, 12, 4, 16), (3, 7, 5, 1, 41),
                            (8, 39, 39, 10, 200)):
        args = (r(ho, hp * m, scale=0.05), r(b, hp, d), r(b, m, d))
        close(ops.cin_layer(*args), ref.cin_layer_ref(*args), 1e-4)
    rows = {}
    m, d, ho = 39, 10, 200
    for b in (512, 4096):
        x0 = r(b, m, d)
        for hp in (39, 200):
            k = hp * m
            w = r(ho, k, scale=(2.0 / (ho + k)) ** 0.5)  # glorot's std
            xp = x0 if hp == m else r(b, hp, d)
            args = (w, xp, x0)
            err = close(ops.cin_layer(*args), ref.cin_layer_ref(*args), 1e-4)
            reps = 20 if b == 512 else 5
            ms = cuda_ms(lambda: ops.cin_layer(*args), reps=reps)
            plain_ms = cuda_ms(lambda: ref.cin_layer_ref(*args), reps=2,
                               warm=1)

            def two_einsums():
                z = torch.einsum("bhd,bmd->bhmd", xp, x0).reshape(b, k, d)
                return torch.einsum("oc,bcd->bod", w, z)

            lib_ms = cuda_ms(two_einsums, reps=2, warm=1)
            nbytes = 4 * (ho * k + b * hp * d + (b * m * d if hp != m else 0)
                          + b * ho * d)
            b_ms, by = bound(nbytes, 2.0 * b * ho * k * d + b * k * d)
            rows[(b, hp)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                "shape": f"B={b} Hp={hp} m={m} D={d} H_out={ho}"}
    for row in rows.values():
        log(f"cin_layer [{row['shape']}]: max_abs_err "
            f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, two einsums {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f} by {row['bound_by']})")
    return rows[(4096, 200)]


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


WINDOW_KERNELS = ("cascade_truncate", "target_attention", "embedding_bag")


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
        if (cnt < 1) == (name in WINDOW_KERNELS):
            raise AssertionError(f"kernel {name} launched {cnt} times on "
                                 f"the serving window path")
    launches = {k: launches[k] for k in WINDOW_KERNELS}
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


# -- phase 6: the zoo's serving cells at full width -------------------------

ZOO = {"dlrm-rm2": "dot_interact", "xdeepfm": "cin_layer"}
ZOO_CALLS = {"serve_p99": 10, "serve_bulk": 2, "retrieval_cand": 1}


def retrieval_matches_forward(mod, cfg, params, user, cand) -> float:
    """retrieval_forward on the first 512 candidates against forward on
    the user's batch broadcast to them, with the candidates swapped in."""
    import torch
    c = cand[:512]
    got = mod.model.retrieval_forward(params, cfg, user, c)
    full = {k: v.expand(len(c), v.shape[1]).clone() for k, v in user.items()}
    full["sparse"][:, -c.shape[1]:] = c
    return close(got, mod.model.forward(params, cfg, full), 1e-5)


def serve_zoo(seed: int) -> dict:
    """Each cell of ``ZOO`` at ``full_config()``: weights and inputs drawn
    from the seed on the card, one warm call and ``ZOO_CALLS[shape]``
    timed calls.  The launch counters are reset just before and read just
    after each cell: each DLRM forward launches dot_interact once, each
    xDeepFM forward cin_layer once per CIN layer (the retrieval cell runs
    one forward per candidate chunk), and nothing else launches."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.configs.xdeepfm_arch import RETRIEVAL_CHUNKS
    from repro_torch.kernels import ops

    launched = {k: 0 for k in ZOO.values()}
    for arch, kernel in ZOO.items():
        mod = configs.get_arch(arch)
        cfg = mod.full_config()
        per_fwd = len(cfg.cin_layers) if arch == "xdeepfm" else 1
        for shape, calls in ZOO_CALLS.items():
            cell = mod.make_cell(shape, cfg=cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args = cell.make_args(seed, "cuda")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            out = cell.fn(*args)  # warm call
            times = []
            for _ in range(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cell.fn(*args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            got = dict(ops.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            fwds = 1 + calls
            if arch == "xdeepfm" and shape == "retrieval_cand":
                fwds *= RETRIEVAL_CHUNKS
            want = {k: 0 for k in got}
            want[kernel] = fwds * per_fwd
            if got != want:
                raise AssertionError(f"{arch} x {shape}: launches {got}, "
                                     f"want {want}")
            launched[kernel] += got[kernel]
            n = (args[2].shape[0] if cell.kind == "retrieval"
                 else args[1]["sparse"].shape[0])
            if out.shape != (n,) or not torch.isfinite(out).all():
                raise AssertionError(f"{arch} x {shape}: logits "
                                     f"{tuple(out.shape)} not finite (n={n})")
            gflop = cell.meta["model_flops"] / 1e9
            log(f"{arch} x {shape} (n={n}): set-up {setup_s:.2f} s; calls "
                f"{', '.join(f'{t:.3f}' for t in times)} ms; "
                f"{gflop / (min(times) * 1e-3) / 1e3:.2f} model TFLOP/s at "
                f"the fastest; peak memory {peak_gb:.2f} GB; launches "
                f"{got[kernel]} {kernel}; logits sum "
                f"{float(out.double().sum()):.6f}")
            if cell.kind == "retrieval":
                err = retrieval_matches_forward(mod, cfg, *args)
                log(f"{arch} retrieval_forward == forward on the broadcast "
                    f"batch (first 512 candidates): max abs err {err:.3e}")
            del args, out, cell
            gc.collect()
            torch.cuda.empty_cache()
    return launched


def zoo_parity(seed: int) -> None:
    """smoke_config DLRM and xDeepFM from one seed, on the CPU and (the
    same weights moved) on the card: logits within 1e-5 with f32 tables
    and 2e-2 with the default bf16 tables."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L

    for arch in ZOO:
        mod = configs.get_arch(arch)
        for table, tol in (("bfloat16", 2e-2), ("float32", 1e-5)):
            cfg = dataclasses.replace(mod.smoke_config(), table_dtype=table,
                                      lookup_dtype=table)
            params = mod.init_smoke(torch.Generator().manual_seed(seed), cfg,
                                    "cpu")
            batch = mod.smoke_batch(np.random.default_rng(seed), cfg)
            batch.pop("label")
            with torch.no_grad():
                want = mod.model.forward(params, cfg, batch)
                got = mod.model.forward(L.to_device(params, "cuda"), cfg,
                                        L.to_device(batch, "cuda"))
            err = close(got, want.cuda(), tol)
            log(f"{arch} smoke_config ({table} tables) card vs cpu: max abs "
                f"err {err:.3e} (tol {tol})")


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
        "dot_interact": check_dot_interact(dev),
        "cin_layer": check_cin(dev),
    }
    for name, r in results.items():
        log(f"{name} [{r['shape']}]: max_abs_err {r['max_abs_err']:.3e}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    stack, st, launches = serve_full(args)
    n_windows = len(st.windows)
    profile_window(stack)
    del stack, st
    torch.cuda.empty_cache()
    zoo_launches = serve_zoo(args.seed)
    small_parity(args.seed)
    zoo_parity(args.seed)

    window_path = f"serving window ({n_windows} windows)"
    paths = {k: window_path for k in launches}
    paths.update({k: f"{arch} cells ({', '.join(ZOO_CALLS)})"
                  for arch, k in ZOO.items()})
    launches.update(zoo_launches)
    tpu = "src/repro/kernels/{}"
    replaces = {"cascade_truncate": tpu.format("cascade_truncate.py:34"),
                "target_attention": tpu.format("target_attention.py:46"),
                "embedding_bag": tpu.format("embedding_bag.py:24"),
                "dot_interact": tpu.format("dot_interact.py:34"),
                "cin_layer": tpu.format("cin.py:34")}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{build.KERNELS[name]}",
         "replaces": replaces[name], "launches": int(launches[name]),
         "path": paths[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "shape": r["shape"]}
        for name, r in results.items()]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
