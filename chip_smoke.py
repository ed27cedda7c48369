#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # one card, from the repository root

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the twelve CUDA kernels and their PyTorch binding from
     ``src/repro_torch/kernels/csrc`` with ``torch.utils.cpp_extension``
     (ninja compiles the sources in parallel);
  3. holds every kernel against its plain-torch version on the card, at
     small shapes and at its path's full widths (truncation exact,
     target attention 2e-5, embedding bag 1e-5, dot interaction and
     flash attention 2e-5 in f32 and 2e-2 in bf16, CIN 1e-4) and times
     both, with the least time the card could take (``bound_ms``) and
     the time of the PyTorch call(s) that compute the same function
     (for dot interaction and CIN a composition of calls: bmm and a
     gather, two einsums; for flash attention compiled flex_attention
     with gemma2's softcap as its score_mod and the causal or window
     block mask, and SDPA on the softcap-free global layer): flash
     attention's f32 rows run the 3xTF32 kernel (mma.sync) and its bf16
     rows the wgmma/TMA kernel; CIN (wgmma, TMA), target attention and
     its backward, f32 flash attention and f32 dot interaction
     (mma.sync) compute their products in f32 as 3xTF32 on the tensor
     cores, so their bound counts those flops at 495/3 TFLOP/s and the
     rest at the f32 peak (the log lines of CIN, target attention, its
     backward and flash attention give
     the bound with all flops at the f32 peak beside it); bf16 dot
     interaction runs bf16 mma.sync; CIN logs B = 512 beside B = 4,096;
     the truncation kernel is checked exact also at C = 257 and 260
     (past the 256 slots it holds in registers, one slot a lane and
     four) with expose below and above C, the embedding bag at D = 2, 3,
     8, 64, 1000, 1030 and L = 1, 1,500 and for bitwise repeats; those two kernels, a few microseconds each, are also timed
     on the device alone (``device_ms``: a CUDA graph of 100 launches,
     replayed after a warm replay), beside ``F.embedding_bag`` both ways
     and the launch floor (the same timing of a one-element ``add_``),
     since eager back-to-back calls time the host's dispatch as much as
     the kernel; and the two backward kernels against their plain
     versions, with bitwise repeats: ``target_attention_bwd`` (relative
     to each gradient's largest magnitude, 5e-5) at small shapes, the
     edges of its tiling at DIN's widths, the experiment's DIN width
     (B = 48, T = 10, d = 16, h 16-8) and DIN's train_batch (B = 65,536,
     N = 1, T = 100, d = 36, h 80-40), with its share of the bound, where
     the forward kernel is also checked at N = 1; ``embedding_bag_bwd``
     (1e-5; its two kernels order the ids themselves) at small shapes,
     int32 and int64 ids, a skewed id, a million rows, YDNN's experiment
     width and the window's shape, timed eager and graph-replayed beside
     the backward of ``F.embedding_bag``, with a profiled call that shows
     its two kernels and nothing else on the device; and the three
     backward kernels training DLRM, xDeepFM and the LMs needs, each
     gradient within 5e-5 (f32) or 2e-2 (bf16) of its largest magnitude
     of the plain version, bitwise repeatable, at small shapes and at
     the training shapes: ``dot_interact_bwd`` at the warp-pipelined
     kernel's edges (B = 1, B one past a whole grid of warps, F = 16,
     17, 32, 33, D = 8, 56, 63, 72, 128, feats at a base off 16 bytes)
     and at DLRM's train_batch (B = 65,536, bf16 and f32; library: dout
     placed into G and a bmm),
     ``cin_layer_bwd`` at xDeepFM's (B = 65,536, Hp = 39 and 200;
     library: the einsums in 8 chunks), ``flash_attention_bwd`` at
     train_4k's T = S = 4,096 for gemma2's heads (global, a 1,024 window
     and a ragged T = 4,000, in bf16 and f32; library: compiled
     flex_attention's backward in each dtype), glm4-9b's,
     minicpm-2b's, granite-moe-1b-a400m's and olmoe-1b-7b's (bf16),
     each bf16 one also against an f32 reference by its relative
     Frobenius error and its worst row's;
  4. serves full-width ``GeneratedSource`` windows through
     ``repro_torch.launch.serve`` (100k-user world, 4000-item corpus,
     paper chains, stage and reward models at full width, random
     weights from the seed): the spike scenario over 6 windows (512
     requests, then 1,536 in windows 2-4: three scoring chunks and a new
     padding bucket mid-stream), with prefetch=2 (a producer thread on
     its own stream) through the CUDA graphs (the scoring programs
     captured when the source is built, each bucket's window program on
     first sight), the kernel launch counters reset just before and
     read just after; checks the budget (max(budget, n c_min) + c_max,
     the guard's bound), the price, the revenue, zero steady-state
     captures, that the window's three kernels launched exactly the
     eager counts (one truncation a window, 16 target attention and one
     bag a chunk) and no other, that the device tables served in window
     0 equal the NumPy host builder on the same stage scores and that
     its revenue equals the plain truncation on those tables; then holds
     the captured windows against ``graphs=False`` bit for bit at a
     pinned price (both buckets) and the scoring graphs against eager
     ``score_slab``, and serves two steady-state windows with
     prefetch=0 under ``torch.cuda.set_sync_debug_mode("error")``;
  4b. (after step 5's profile, which stays comparable with earlier
     runs) on the same source, before its graphs are released, serves two
     multi-price pipelines, 4 windows of 512 requests each, prefetch 2,
     through their CUDA graphs: 4 priced tenants whose budgets spread 4x
     (a (4,) price vector), and 3 priced tenants x 2 regions (a (5,)
     price vector, the flow split, gram budgets and kappa * CI scales
     from a fixed two-region trace whose region b doubles in windows
     2-3), each with the counters reset before and read after; checks
     every tenant's and region's spend against its budget (+ one
     option's cost), the eager launch counts, zero steady-state
     captures, captured == ``graphs=False`` bitwise at a pinned price
     across the budget/scale change, no host sync in a steady window;
     then a materialized ``CascadeServer`` over one full-width slab
     serves through the truncation kernel exactly as the plain oracle;
  4c. on the same source, before its graphs are released, serves the
     CLI's three carbon days through ``launch.serve``'s own day functions
     (``carbon_day``, and ``region_day`` for both geo days), each at a window
     offset of its own, 4 windows of the diurnal curve (512, 819, 512,
     204 requests; 510, 819, 510, 204 in three tenant blocks), prefetch
     2, synchronised after each window, the counters reset before each
     day and read after it: carbon (a diurnal trace at a mean of 450
     g/kWh, carbon pricing, a ``CarbonLedger`` on the pipeline),
     georegions (two region traces 8 h apart, the flow split, a ledger a
     region) and geotenants (3 priced tenants spread 4x x 2 regions,
     each region capped at 0.6 of the total); checks every window's
     spend against its budget, tenant and region caps plus one option's
     cost, zero steady-state captures, the eager launch counts and no
     other kernel, the ledgers (requests == served, FLOPs == the chain
     costs of the decisions each region served, recomputed exactly,
     gCO2e == kWh x the window's intensity) and each report CSV (with a
     ``region`` column on the geo days); prints each day's wall ms,
     window ms and ledger reports; then serves the carbon day again with
     an ``Obs`` attached (metrics, spans, the JSONL flight log), held to
     the first run bit for bit, and one more warm window of that
     pipeline, ledger and obs attached, under
     ``torch.cuda.set_sync_debug_mode("error")``; last, the CLI itself:
     first its trained stack (``experiments.build_serving_stack(
     serve_config())``: 2,000 users, 400 items, the four cascade models
     and the reward model trained on the card, into this run's own
     experiment cache; exactly the training's launches, timed), then
     ``serve.main`` (as ``python -m repro_torch.launch.serve --source
     generated --scenario carbon`` runs it) loads it, builds a
     ``GeneratedSource`` over a 100,000-user world of it and serves the
     carbon day with ``--metrics-out``, ``--trace-out`` and
     ``--profile-dir``: its launches equal the eager counts (the server's
     scores, the scoring capture's warm-up on the zero batch), the
     metrics count the table-cache misses, the flight log has a row a
     window, the span trace holds ``chunk_tables`` and every serving
     span, and the profiler's trace holds the three window kernels;
  5. profiles one more full-width window (warm, through the graphs)
     under ``torch.profiler`` and prints its wall time, the device's busy
     time and idle share, each phase range's host and device span, the
     operators that took the most device time, each graph's capture time
     and the memory its pool reserved; then releases the graphs;
  6. serves the model zoo's ``dlrm-rm2`` and ``xdeepfm`` cells at
     ``full_config()`` through ``configs.get_arch(...).make_cell(...)``:
     serve_p99 (B = 512) x 10, serve_bulk (B = 262,144) x 2 and
     retrieval_cand (1 user x 1,000,000 candidates) x 1, each after one
     warm call, with the counters reset before and read after each cell
     (dot_interact once per DLRM forward, cin_layer three times per
     xDeepFM forward); checks finite logits, prints each call's ms and
     the peak memory, and holds retrieval_forward against forward on
     the broadcast batch; profiles one more DLRM serve_bulk call (device
     busy, idle share, dot_interact's share of busy), outside the count;
  7. serves a small world on the card and on the CPU from the same seed
     and holds the two runs' decisions and prices against each other;
     runs smoke_config DLRM and xDeepFM from one seed on both and holds
     their logits against each other;
  6b. (after 7) BST's four cells at ``full_config()`` (a 4 M-item table,
     f32, no kernel on the path, so no launch at all): serve_p99 (B =
     512) x 10, serve_bulk (262,144) x 2, retrieval_cand (1 x 1,000,000
     in 8 chunks) x 1, train_batch (65,536, AdamW) x 3, each after a warm
     call: ms, model TFLOP/s, peak memory, finite logits and losses;
     serve_p99's logits held to the port's CPU run of the same weights
     and batch (1e-5), the retrieval's first 512 candidates to
     ``forward`` on the broadcast batch (1e-5);
  6c. SchNet's four train cells at ``full_config(shape)`` and the JAX
     sizes, nothing cut (ogb_products: 2,449,029 nodes, 61,859,328
     edges, in 15 edge chunks recomputed in the backward): one warm and
     5 timed steps (2 at ogb_products), no launch, ms, model TFLOP/s,
     peak memory, the losses; at molecule and full_graph_sm the chunked
     path (1,000-edge chunks) against the unchunked one on the card
     (loss 1e-5, gradients 5e-5 of their largest magnitude) and whether
     two identical gradient evaluations are bitwise equal (``index_add``
     sums by atomics: a finding, not a gate);
  8. serves gemma2-2b at ``full_config()`` in bf16: prefill of one
     32,760-token sequence and 8 greedy decode steps, its launches
     counted; then, outside that count, holds the first step against a
     prefill of those 32,761 tokens in f32, and in bf16 within bf16
     prefill(T + 1)'s own distance from f32; then the
     prefill_32k (B = 4) x 1 and decode_32k (B = 8, cache length
     32,767) x 8 cells after one warm call each, with the counters reset
     before and read after each (the wgmma flash kernel 26 times a bf16
     prefill forward, never in decode; the f32 one only in the identity
     check's two f32 prefills, whose wall times it prints); the profiled
     prefill prints the wgmma kernel's share of device busy; then gemma2
     smoke_config on the card against the CPU;
  8b. glm4-9b and minicpm-2b at ``full_config()``: the bf16 kernel at
     each one's head layout (32 query heads on 2 kv heads at dh = 128;
     36 heads at dh = 64), B = 1, T = S = 8,192, causal, against its
     plain version (2e-2), timed beside it and beside SDPA, with its
     bound; the prefill_32k and decode_32k cells at the config modules'
     cut batches (glm4 B = 4 and 32, minicpm B = 4 and 4) after a warm
     call, x 1 and x 4, the wgmma kernel 40 times a prefill forward and
     never in decode, a profiled decode step; then the f32 step(T) =
     prefill(T + 1) identity at T = 16,376 and full depth within 2e-3,
     the f32 kernel 80 times;
  8c. the MoE LMs, granite-moe-1b-a400m and olmoe-1b-7b, at
     ``full_config()``: the bf16 kernel at each one's head layout (16
     query heads on 8 kv heads at dh = 64; 16 heads at dh = 128) as in
     8b; one MoE layer at the full widths on 4,096 tokens, the grouped
     path (``lm._moe_grouped``) against the plain one (``lm._moe_ref``)
     in bf16 (2e-2) and f32 (1e-5), forward and every gradient, the
     bf16 output against the plain f32 one (rel 1e-2 over the tokens
     routed alike, the others counted), bitwise repeats, no token
     dropped, the grouped and the plain forward timed there and at a
     decode_32k step's tokens; the prefill_32k and decode_32k cells at the config
     modules' cut batches (granite B = 4 and 32, olmoe B = 4 and 12)
     after a warm call, x 1 and x 2, the wgmma kernel once a layer a
     prefill forward and never in decode, one host read of the routing
     counts a layer a call; the f32 identity as in 8b, each layer's
     routing margin of the last token logged and its experts the same
     in the step and in prefill(T + 1);
  9. trains on the card.  9a: DIN's train_batch cell at
     ``full_config()`` (10 M items, B = 65,536) through
     ``configs.get_arch("din").make_cell("train_batch")``, one warm and
     5 timed steps: ms a step, model TFLOP/s, peak memory, exactly one
     ``target_attention`` and one ``target_attention_bwd`` launch a step
     and nothing else, finite losses and a finite gradient on every
     leaf; a profiled step split into the forward kernel, the backward
     kernels and the rest.  9b: the paper's offline experiment at
     tests/conftest.py's ``system_exp`` config
     (``experiments.build_experiment`` and ``train_reward_model``):
     ``target_attention_bwd`` launched once a
     DIN step (240), ``embedding_bag_bwd`` once a YDNN step (120); the
     claims of tests/test_system.py on the card-trained experiment;
     then the trained models and reward model serve 4 windows of 512
     through ``GeneratedSource`` over a 100,000-user ``StreamingWorld``
     (the JAX CLI's ``--source generated``) within budget at the eager
     launch counts; then DIN's smoke config trained 3 steps from one
     init on the card and on the CPU, parameters within 1e-5.  9c: the
     zoo's train cells at full width, one warm and 3 (recsys) or 2 (LM)
     timed steps each, the counters reset before and read after:
     DLRM-RM2's and xDeepFM's train_batch (B = 65,536, no cut; the
     hybrid optimizer), gemma2-2b's, glm4-9b's, minicpm-2b's,
     granite-moe-1b-a400m's and olmoe-1b-7b's train_4k (B = 8 of 4,096
     in 2 microbatches, glm4 at 12 of 40 layers, olmoe at its config's
     ``TRAIN_LAYERS`` of 16): ms a step, model TFLOP/s, peak memory,
     finite losses, exactly each step's forward and backward kernel
     launches (and one more DLRM-RM2, xDeepFM and gemma2-2b step
     profiled: device busy, the dot interaction, CIN and flash kernels'
     shares); then each
     arch's smoke widths from one init on the card against the CPU (the
     loss within 1e-5, every gradient within 5e-5 of its largest
     magnitude, 2e-2 for the bf16 tables; the LMs' run the f32 flash
     kernels);
 10. serves the JAX package's CLI on the card, on the trained stack of
     step 4c, each step's launches counted and held to its eager counts:
     (a) ``serve.main([])``, the CLI's defaults (12 spike windows of 96
     over ``--source table``); (b) the legacy host loop and the carbon
     legacy loop on the same stack, and the legacy loop's full reward
     matrix against the fused pass's grouped one within 1e-5, with equal
     decisions, downgrades and revenue at the legacy controller's prices
     when both score with the same matrix; (c) ``--source memmap`` twice
     through the CLI (the first saves the universe); the warm windows'
     host ms and CUDA-event span on the table, memmap and generated
     sources and the legacy loop's ms, and one warm table window under
     torch.profiler (device busy, idle share); (d) a 100,000-user universe of the stack's
     streamed world (0.512 GB of tables) made by
     ``GeneratedSource.window_for_users``, saved, loaded memmapped with
     its tables on the device and on the host, each equal to
     ``GeneratedSource``'s windows bit for bit, tables and served
     results; (e) the three carbon days through ``serve.main --small``
     at the commands of the committed ``results/carbon_report*.csv``,
     writing ``results/torch/``, each column's largest difference from
     the committed ledger printed (information: those came from
     JAX-trained models); (f) the four greenflow-cascade cells at
     ``full_config()``, 3 calls each, ms and model TFLOP/s, and
     ``rank_serve``'s ``target_attention`` (B = 1,024 x N = 200) held to
     its plain version on its first 64 users;
 11. serves over several processes on the card (the request mesh,
     ``distributed.multihost``, gloo through the host): (a) prints the
     card's compute mode and has two processes form a gloo group and
     gather a CUDA tensor staged through the host; (b) the cheap replay
     stack of tests/test_multihost.py at S = 8 shards
     (``tests/torch_mh_child.py``): the plain stream in one process and
     over 2 and 4, geotenants in one and over 2, and the elastic resume
     (2 processes serve windows 0-2 and checkpoint, 4 resume at 3-5, one
     resumes the same checkpoint); (c) phase 4's world at full width
     and S = 2, one process alone, then two (``--child full``), each
     host's host ms, device ms (the CUDA events' span around
     ``serve_window``), the wait for its own scoring and the gather's
     exchange apart (host ms), launches and peak memory printed; in (b)
     and (c) every host's prices and spends equal the one-process run's
     bit for bit, the hosts' rows stitch to its decisions and regions,
     zero steady-state captures, each member's launches its eager counts
     (counted in the member, reset before its stream), and each member
     holds ``cascade_truncate`` bit for bit to its plain version and to
     the revenue served at its per-shard rows (256 and 768 in (c)); (d)
     the CLI: the JAX CLI's multi-process refusals before any training,
     the ``--small`` trained stack built into this run's cache, then
     ``--shards 2`` in one process and ``--processes 2`` at once: the
     same reward-parameter digest on all three, every window's price
     and spend in the ``.host0`` and ``.host1`` flight logs equal to
     ``--shards 2``'s;
 12. prints the smoke's wall time, the ``kernels`` JSON line (the
     backward kernels' launches are the training paths'; phase 11's
     members' launches are added to the window kernels' counts; the
     wgmma row carries phases 8b's and 8c's head-layout rows), the card
     line and,
     last, the ``{"ok": true, ...}`` line.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device, or without the repository's ``src/``
beside it, it fails before printing any result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BF16_S = 989e12  # H100 SXM bf16 tensor cores, dense
PEAK_TF32_S = 495e12  # H100 SXM TF32 tensor cores, dense


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


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


def graph_ms(fn, *, launches: int = 100, replays: int = 10) -> float:
    """Device time of one ``fn()`` alone: a CUDA graph holding
    ``launches`` calls, replayed once to warm it, then ``replays`` times
    between CUDA events, over the calls replayed.  ``cuda_ms`` times
    back-to-back eager calls, which for a kernel of a few microseconds is
    the host's dispatch as much as the device.  Capture runs the
    wrappers' Python but launches nothing, so it counts nothing
    (``ops.recording``); these timing launches stay out of LAUNCHES."""
    import torch
    from repro_torch.kernels import ops
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs ask
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with ops.recording(), torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def launch_floor_ms(dev) -> float:
    """``graph_ms`` of a one-element ``add_``: the least time a graph-
    replayed launch takes on this card."""
    import torch
    x = torch.zeros(1, device=dev)
    return graph_ms(lambda: x.add_(1.0))


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_F32_S,
          tf32x3_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes``, doing ``ops`` at the
    peak rate of the inputs' type and ``tf32x3_ops`` product flops as
    3xTF32 on the tensor cores (three TF32 passes each, 495/3 TFLOP/s),
    and which bounds it: the largest of the three terms, since the
    memory, the CUDA cores and the tensor cores work side by side."""
    t_b = nbytes / PEAK_BYTES_S
    t_o = max(ops / peak_ops, 3.0 * tf32x3_ops / PEAK_TF32_S)
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


def window_truncation_inputs(gen, dev, layout):
    """The window's truncation shape: its layout's (G, 512, cap) tables
    and 512 requests, n3 drawn from the layout's chains."""
    return truncation_inputs(layout.p_sorted.shape[0], 512, layout.cap, 512,
                             sorted(set(layout.n3_of_chain.tolist())), gen,
                             dev)


def check_truncation(gen, dev, layout, expose):
    import torch
    from repro_torch.kernels import ops, ref

    # small; then C past the 256 slots the kernel holds in registers,
    # one slot a lane (257) and four (260), an odd B, with expose below
    # and above C
    cases = [(truncation_inputs(3, 5, 40, 32, [1, 7, 20, 40], gen, dev), 6)]
    for c in (257, 260):
        for e in (20, 300):
            cases.append((truncation_inputs(4, 16, c, 33, [0, 1, 100, c],
                                            gen, dev), e))
    for args, e in cases:
        if not torch.equal(ops.cascade_truncate(*args, expose=e),
                           ref.cascade_truncate_ref(*args, expose=e)):
            raise AssertionError(f"truncation kernel differs from its "
                                 f"plain version at C = "
                                 f"{args[0].shape[2]}, expose {e}")
    g_n, cap = layout.p_sorted.shape[0], layout.cap
    full = window_truncation_inputs(gen, dev, layout)
    got = ops.cascade_truncate(*full, expose=expose)
    want = ref.cascade_truncate_ref(*full, expose=expose)
    if not torch.equal(got, want):
        raise AssertionError("truncation kernel differs from its plain "
                             "version")
    err = close(got, want, 0.0)
    ms = cuda_ms(lambda: ops.cascade_truncate(*full, expose=expose),
                 reps=200)
    device_ms = graph_ms(lambda: ops.cascade_truncate(*full, expose=expose))
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
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "shape": f"G={g_n} U=512 C={cap} B=512 expose={expose}"}


def attention_bound(q, mask, h1: int, h2: int):
    """The target attention's least time for candidates ``q`` (B, N, d)
    (one list shared when its batch stride is 0) against ``mask`` (B, T):
    ((bound ms, by), the bound with every flop at the f32 peak)."""
    b, n, d = q.shape
    t = mask.shape[1]
    user_steps = float((mask != 0).sum())
    steps = user_steps * n  # unmasked (b, n, t)
    cands = n if q.stride(0) == 0 else b * n
    products = steps * (2 * d * h1 + 2 * h1 * h2)
    rest = (steps * (d + 2 * h1 + 2 * h2 + 2 * d)
            + (cands + user_steps) * 2 * d * h1)
    nbytes = 4 * (cands * d + b * t * d + b * t + 4 * d * h1 + h1 * h2
                  + h1 + 2 * h2 + 1 + b * n * d)
    return (bound(nbytes, rest, tf32x3_ops=products),
            bound(nbytes, products + rest)[0])


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
    # step).  The kernel runs the two products, (q*k) Wp and . W2, in
    # 3xTF32 on the tensor cores, the rest in f32 on the CUDA cores.
    (b_ms, by), f32_ms = attention_bound(full[0], hist_mask, h1, h2)
    shape = f"B={b} N={n} T={t} d={d} h1={h1} h2={h2}"
    log(f"target_attention [{shape}]: max_abs_err {err:.3e}, {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, bound {b_ms:.4f} by {by}, all in f32 "
        f"{f32_ms:.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": shape}


def window_bag_inputs(gen, dev, hist_ids, hist_mask, n_items, dim):
    """YDNN's mean history bag at the window's shape: a (n_items, dim)
    table at the models' scale, a real slab's ids and mask / count."""
    import torch
    table = (0.02 * torch.randn(n_items, dim, generator=gen)).to(dev)
    w = hist_mask / torch.clamp(hist_mask.sum(-1, keepdim=True), min=1.0)
    return table, hist_ids, w


def library_bag(table, ids, w):
    """``F.embedding_bag``, the PyTorch call computing the same sums."""
    import torch.nn.functional as F
    return F.embedding_bag(ids, table, mode="sum", per_sample_weights=w)


def check_embedding_bag(gen, dev, hist_ids, hist_mask, n_items, dim):
    import torch
    from repro_torch.kernels import ops, ref

    # small; a float at a time (D = 2, 3, 1030), 4-float units (D = 8,
    # 20, 64, 1000); one id and 1,500 ids (the table at the models' scale
    # there: a 1,500-term f32 sum of unit-scale rows is beyond 1e-5 in
    # any order); an odd B
    for v, d, b, l, scale in ((50, 20, 7, 9, 1.0), (60, 3, 5, 1, 1.0),
                              (60, 2, 5, 100, 1.0), (60, 8, 5, 100, 1.0),
                              (100, 64, 7, 100, 1.0),
                              (60, 3, 3, 1500, 0.02),
                              (100, 1030, 3, 100, 1.0),
                              (100, 1030, 2, 1500, 0.02),
                              (100, 1000, 5, 1500, 0.02)):
        table_s = (scale * torch.randn(v, d, generator=gen)).to(dev)
        ids_s = torch.randint(0, v, (b, l), generator=gen).to(dev)
        w_s = torch.rand(b, l, generator=gen).to(dev)
        for w in (w_s, None):
            close(ops.embedding_bag(table_s, ids_s, w),
                  ref.embedding_bag_ref(table_s, ids_s, w), 1e-5)
    args = window_bag_inputs(gen, dev, hist_ids, hist_mask, n_items, dim)
    table, _, w = args
    got = ops.embedding_bag(*args)
    err = close(got, ref.embedding_bag_ref(*args), 1e-5)
    if not torch.equal(got, ops.embedding_bag(*args)):
        raise AssertionError("embedding bag kernel is not bitwise "
                             "repeatable")
    ms = cuda_ms(lambda: ops.embedding_bag(*args), reps=200)
    device_ms = graph_ms(lambda: ops.embedding_bag(*args))
    plain_ms = cuda_ms(lambda: ref.embedding_bag_ref(*args), reps=50)
    lib_ms = cuda_ms(lambda: library_bag(*args), reps=200)
    lib_device_ms = graph_ms(lambda: library_bag(*args))
    nnz = float((w != 0).sum())
    b, bag = hist_ids.shape
    nbytes = nnz * dim * 4 + b * bag * 8 + b * dim * 4
    b_ms, by = bound(nbytes, 2 * nnz * dim)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "library_device_ms": lib_device_ms,
            "shape": f"V={n_items} D={dim} B={b} L={bag}"}


def attention_inputs(gen, dev, b, n, t, d, h1, h2, *, full=False, dead=0):
    """Target attention's inputs and an upstream gradient dOut: q and keys
    at the models' scale, the mask full (``full``, as DIN's train_batch
    cell draws it) or with about 30 % of the steps padded, and the first
    ``dead`` users' steps all padded."""
    import torch

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to(dev)
    q, keys = r(b, n, d, scale=0.3), r(b, t, d, scale=0.3)
    mask = (torch.ones(b, t) if full
            else (torch.rand(b, t, generator=gen) > 0.3).float())
    mask[:dead] = 0.0
    mask = mask.to(dev)
    ws = []
    for di, do in ((4 * d, h1), (h1, h2), (h2, 1)):
        ws += [r(di, do, scale=di ** -0.5), r(do, scale=0.1)]
    return r(b, n, d), (q, keys, mask, *ws)


GRAD_NAMES = ("dq", "dkeys", "dW1", "db1", "dW2", "db2", "dW3", "db3")
# the backward against its plain version, relative to each gradient's
# largest magnitude: the weight gradients are f32 sums over every pair
# (6.5 M at DIN's train_batch), taken in another order than the plain
# version's (a first card run of the kernel: at most 5.3e-6)
BWD_TOL = 5e-5


def close_grads(got, want, what: str) -> tuple[float, float]:
    """(the largest error of the eight gradients relative to each one's
    largest magnitude, the largest absolute error); raises when the first
    is above ``BWD_TOL``."""
    import torch
    torch.cuda.synchronize()
    rel_worst = abs_worst = 0.0
    for name, g, w in zip(GRAD_NAMES, got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {name} {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}, or not finite")
        err = float((g.double() - w.double()).abs().max())
        rel = err / (float(w.abs().max()) or 1.0)
        if rel > BWD_TOL:
            raise AssertionError(f"{what}: {name} off by {rel:.3e} of its "
                                 f"largest magnitude (tol {BWD_TOL})")
        rel_worst, abs_worst = max(rel_worst, rel), max(abs_worst, err)
    return rel_worst, abs_worst


def attention_bwd_bound(mask, n, d, h1, h2, nbytes
                        ) -> tuple[float, str, float]:
    """The least time of the backward, and the same bound with every flop
    at the f32 peak of the CUDA cores.  W1's row blocks fold into one
    (d, h1) matrix a candidate, M = (Wk - Wd) + diag(q) Wp, so that per
    unmasked pair the products are 2 d h1 for the pre-activation k M,
    2 d h1 for dkeys = dz1 M^T and 2 d h1 for G = sum_t k (x) dz1, from
    which dW1's four blocks and dq follow once a candidate; 2 h1 h2 each
    for a2, dz1 and dW2.  Those 6 d h1 + 6 h1 h2 product flops are counted
    as 3xTF32 on the tensor cores (as the forward's are), the elementwise
    terms at the f32 peak; the work once a candidate is left out."""
    pairs = float((mask != 0).sum()) * n
    products = pairs * (6 * d * h1 + 6 * h1 * h2)
    rest = pairs * (4 * h1 + 6 * h2 + 12 * d)
    b_ms, by = bound(nbytes, rest, tf32x3_ops=products)
    return b_ms, by, bound(nbytes, products + rest)[0]


def check_target_attention_bwd(gen, dev):
    """The backward kernel against ``ref.target_attention_bwd_ref``: small
    shapes with padded histories and several candidates a user, the
    tiling's edges at DIN's widths (3,700 pairs, B below the grid, users
    with every step padded, N = 2 with T = 17, B = 4,096), the
    experiment's DIN (d = 16, h 16-8, T = 10, N = 1, B = 48) and DIN's
    train_batch (B = 65,536, N = 1, T = 100, d = 36, h 80-40, full
    histories), where the forward kernel is also checked at N = 1; a
    bitwise repeat at each."""
    import torch
    from repro_torch.kernels import ops, ref

    def check(shape, **kw):
        dout, args = attention_inputs(gen, dev, *shape, **kw)
        got = ops.target_attention_bwd(dout, *args)
        errs = close_grads(got, ref.target_attention_bwd_ref(dout, *args),
                           f"target_attention_bwd {shape}")
        again = ops.target_attention_bwd(dout, *args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"target_attention_bwd {shape} is not "
                                 f"bitwise repeatable")
        return errs, dout, args

    for shape in ((3, 2, 7, 8, 12, 6), (5, 3, 40, 16, 16, 8),
                  (2, 1, 33, 64, 128, 64), (1, 1, 1, 4, 3, 2),
                  (37, 1, 100, 36, 80, 40), (5, 1, 100, 36, 80, 40),
                  (6, 2, 17, 36, 80, 40), (4096, 1, 100, 36, 80, 40)):
        check(shape)
    check((300, 1, 100, 36, 80, 40), dead=3)
    (exp_err, _), dout, args = check((48, 1, 10, 16, 16, 8))
    exp_ms = cuda_ms(lambda: ops.target_attention_bwd(dout, *args), reps=20)
    log(f"target_attention_bwd [experiment's DIN: B=48 N=1 T=10 d=16 h1=16 "
        f"h2=8]: rel err {exp_err:.3e}, {exp_ms:.4f} ms (three launches: "
        f"prep, pairs, finish)")
    b, n, t, d, h1, h2 = 65_536, 1, 100, 36, 80, 40
    (err, abs_err), dout, args = check((b, n, t, d, h1, h2), full=True)
    fwd_err = close(ops.target_attention(*args),
                    ref.target_attention_ref(*args), 2e-5)
    # the forward kernel is built for many candidates a user (a block
    # serves 128 of one user's); training calls it with one a row
    fwd_ms = cuda_ms(lambda: ops.target_attention(*args), reps=2, warm=1)
    fwd_plain_ms = cuda_ms(lambda: ref.target_attention_ref(*args), reps=2,
                           warm=1)
    ms = cuda_ms(lambda: ops.target_attention_bwd(dout, *args), reps=3,
                 warm=1)
    plain_ms = cuda_ms(lambda: ref.target_attention_bwd_ref(dout, *args),
                       reps=1, warm=1)
    n_w = 4 * d * h1 + h1 + h1 * h2 + 2 * h2 + 1
    nbytes = 4 * (2 * b * n * d + b * t * d + b * t + n_w  # dout, q; keys
                  + b * n * d + b * t * d + n_w)  # dq, dkeys, dW
    b_ms, by, f32_ms = attention_bwd_bound(args[2], n, d, h1, h2, nbytes)
    shape = f"B={b} N={n} T={t} d={d} h1={h1} h2={h2}"
    log(f"target_attention_bwd [{shape}, DIN's train_batch]: error "
        f"{err:.3e} of the largest magnitude (tol {BWD_TOL}), max abs err "
        f"{abs_err:.3e}, bitwise repeat; {ms:.4f} ms, "
        f"{100 * b_ms / ms:.2f} % of the bound (plain {plain_ms:.4f}, "
        f"bound {b_ms:.4f} by {by}, all in f32 {f32_ms:.4f}); the forward "
        f"kernel at N = 1: max abs err {fwd_err:.3e} (tol 2e-5), "
        f"{fwd_ms:.4f} ms "
        f"(plain {fwd_plain_ms:.4f})")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": shape}


def kernel_name(key: str) -> str:
    """A profiler key's function name, without namespace, template
    arguments or signature."""
    import re
    names = re.findall(r"(\w+)(?:<[^()]*>)?\(", key)
    return names[0] if names else key


def device_kernels(fn) -> dict:
    """The CUDA kernels (and memory operations) ``fn()`` runs on the
    device, by name -> count, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def check_embedding_bag_bwd(gen, dev, hist_ids, hist_mask, n_items, dim):
    """The backward kernels (which order the ids themselves: a counting
    sort by row) against ``ref.embedding_bag_bwd_ref``: small shapes (a
    pass of 128 columns and more, one id a bag, plain sums), int32 and
    int64 ids, an id holding 90 % of the positions (dyadic data, so its
    46,000-term sum is exact in any order and the check is on the order),
    a million rows for 51,200 ids, the window's shape (a real slab's ids
    and mask / count into a (4000, 32) table) and YDNN's experiment width
    (V = 200, D = 8, B = 48, L = 10); bitwise repeats; beside the backward
    of ``F.embedding_bag(mode="sum", per_sample_weights=...)``, timed
    eager and graph-replayed (``device_ms``, beside the launch floor); a
    profiled call shows the two kernels and nothing else on the device."""
    import torch
    from repro_torch.kernels import ops, ref

    def check(dout, ids, w, v, exact=False):
        got = ops.embedding_bag_bwd(dout, ids, w, v)
        want = ref.embedding_bag_bwd_ref(dout, ids, w, v)
        err = close(got, want, 1e-5)
        if exact and not torch.equal(got, want):
            raise AssertionError("embedding_bag_bwd: dyadic sums not exact")
        if not torch.equal(got, ops.embedding_bag_bwd(dout, ids, w, v)):
            raise AssertionError("embedding_bag_bwd is not bitwise "
                                 "repeatable")
        return err

    for v, d, b, l in ((7, 3, 4, 5), (50, 300, 9, 70), (60, 1, 3, 1),
                       (1000, 64, 200, 300), (1_000_000, 32, 512, 100)):
        ids = torch.randint(0, v, (b, l), generator=gen).to(dev)
        w = (torch.rand(b, l, generator=gen)
             * (torch.rand(b, l, generator=gen) > 0.3)).to(dev)
        dout = torch.randn(b, d, generator=gen).to(dev)
        for weights in (w, None):
            for dtype in (torch.int64, torch.int32):
                check(dout, ids.to(dtype), weights, v)
    ids = torch.randint(0, n_items, (512, 100), generator=gen)
    ids = torch.where(torch.rand(512, 100, generator=gen) < 0.9,
                      torch.full_like(ids, 3), ids).int().to(dev)
    w = (torch.randint(0, 5, (512, 100), generator=gen).float() / 4).to(dev)
    dout = torch.randint(-4, 5, (512, dim), generator=gen).float().to(dev)
    for weights in (w, None):
        check(dout, ids, weights, n_items, exact=True)
    skew_ms = cuda_ms(lambda: ops.embedding_bag_bwd(dout, ids, w, n_items),
                      reps=5)
    hist = torch.randint(0, 200, (48, 10), generator=gen).int().to(dev)
    mask = (torch.rand(48, 10, generator=gen) > 0.3).float().to(dev)
    _, _, w_exp = window_bag_inputs(gen, dev, hist, mask, 200, 8)
    d_exp = torch.randn(48, 8, generator=gen).to(dev)
    exp_err = check(d_exp, hist, w_exp, 200)
    exp_ms = cuda_ms(lambda: ops.embedding_bag_bwd(d_exp, hist, w_exp, 200),
                     reps=50)
    log(f"embedding_bag_bwd [YDNN's experiment width: V=200 D=8 B=48 "
        f"L=10]: max abs err {exp_err:.3e}, {exp_ms:.4f} ms; an id on 90 % "
        f"of V={n_items} D={dim} B=512 L=100: exact, {skew_ms:.4f} ms")
    table, ids, w = window_bag_inputs(gen, dev, hist_ids, hist_mask,
                                      n_items, dim)
    b, bag = ids.shape
    dout = torch.randn(b, dim, generator=gen).to(dev)
    err = check(dout, ids, w, n_items)
    ran = device_kernels(lambda: ops.embedding_bag_bwd(dout, ids, w,
                                                       n_items))
    if len(ran) > 2 or not all("embedding_bag_bwd_" in k for k in ran):
        raise AssertionError(f"embedding_bag_bwd ran {ran} on the device, "
                             f"want its two kernels only")
    ms = cuda_ms(lambda: ops.embedding_bag_bwd(dout, ids, w, n_items),
                 reps=100)
    device_ms = graph_ms(lambda: ops.embedding_bag_bwd(dout, ids, w,
                                                       n_items))
    floor_ms = launch_floor_ms(dev)
    plain_ms = cuda_ms(lambda: ref.embedding_bag_bwd_ref(dout, ids, w,
                                                         n_items), reps=50)
    tab = table.clone().requires_grad_(True)
    y = library_bag(tab, ids, w)
    close(torch.autograd.grad(y, tab, dout, retain_graph=True)[0],
          ops.embedding_bag_bwd(dout, ids, w, n_items), 1e-5)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(y, tab, dout,
                                                 retain_graph=True),
                     reps=100)
    nnz = float((w != 0).sum())
    nbytes = (b * dim * 4 + b * bag * (ids.element_size() + 4)
              + n_items * dim * 4)
    b_ms, by = bound(nbytes, 2 * nnz * dim)
    shape = f"V={n_items} D={dim} B={b} L={bag}"
    log(f"embedding_bag_bwd [{shape}]: max abs err {err:.3e}, bitwise "
        f"repeat; {ms:.4f} ms eager, device_ms {device_ms:.5f} (launch floor "
        f"{floor_ms:.5f}; plain {plain_ms:.4f}, bound {b_ms:.5f} by {by}, "
        f"F.embedding_bag's backward {lib_ms:.4f}); a profiled call ran "
        f"{', '.join(f'{kernel_name(k)} x{c}' for k, c in ran.items())} "
        f"and nothing else")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "shape": shape}


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
            nbytes = b * 27 * 64 * esize + b * p * esize
            flops = 2.0 * b * p * 64
            # bf16 products on the bf16 tensor cores, f32 ones as 3xTF32
            b_ms, by = (bound(nbytes, flops, PEAK_BF16_S)
                        if dt == torch.bfloat16
                        else bound(nbytes, 0.0, tf32x3_ops=flops))
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
    rows, f32_bounds = {}, {}
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
            # the product in 3xTF32 on the tensor cores, z in f32
            products, z = 2.0 * b * ho * k * d, float(b * k * d)
            b_ms, by = bound(nbytes, z, tf32x3_ops=products)
            rows[(b, hp)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                "shape": f"B={b} Hp={hp} m={m} D={d} H_out={ho}"}
            f32_bounds[(b, hp)] = bound(nbytes, products + z)[0]
    for key, row in rows.items():
        log(f"cin_layer [{row['shape']}]: max_abs_err "
            f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, two einsums {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f} by {row['bound_by']}, all in f32 "
            f"{f32_bounds[key]:.4f})")
    return rows[(4096, 200)]


def attention_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits, positions counted from 0."""
    import torch
    q = torch.arange(t, dtype=torch.int64)
    hi = torch.clamp(q + 1, max=s) if causal else torch.full_like(q, s)
    lo = torch.clamp(q - window + 1, min=0) if window > 0 else \
        torch.zeros_like(q)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_bound(b, t, s, h, hk, dh, esize, window, causal=True,
                all_f32=False):
    """Each of q, k, v read once and the output written once; 4 dh flops
    per admitted (query, key) pair and head, on the tensor cores: bf16 at
    its peak, f32 as 3xTF32 (``all_f32``: at the CUDA cores' f32 peak
    instead, which the log prints beside it)."""
    nbytes = esize * (2.0 * b * t * h * dh + 2.0 * b * s * hk * dh)
    ops_n = 4.0 * dh * b * h * attention_pairs(t, s, causal, window)
    if esize == 2:
        return bound(nbytes, ops_n, PEAK_BF16_S)
    if all_f32:
        return bound(nbytes, ops_n)
    return bound(nbytes, 0.0, tf32x3_ops=ops_n)


def flex_library(dev):
    """One PyTorch call that computes gemma2's attention layer:
    ``flex_attention`` compiled, with the softcap as its score_mod and
    the causal (global) or causal sliding-window (local) block mask.
    Returns ``call(x, name) -> output (B, T, H, dh)`` for q, k, v in the
    kernel's layout.  Timed here only; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def softcap(score, b, h, q_idx, kv_idx):
        return 50.0 * torch.tanh(score / 50.0)

    def causal(b, h, q_idx, kv_idx):
        return kv_idx <= q_idx

    def local(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) & (q_idx - kv_idx < 4096)

    for knob in ("cache_size_limit", "recompile_limit"):
        if hasattr(torch._dynamo.config, knob):
            setattr(torch._dynamo.config, knob, 64)
    flex = torch.compile(flex_attention, dynamic=False)
    masks = {}

    def call(x, name):
        t, s = x[0].shape[1], x[1].shape[1]
        if (t, s, name) not in masks:
            masks[(t, s, name)] = create_block_mask(
                local if name == "local" else causal, None, None,
                t, s, device=dev)
        q, k, v = (y.transpose(1, 2) for y in x)
        out = flex(q, k, v, score_mod=softcap,
                   block_mask=masks[(t, s, name)], scale=1 / 16,
                   enable_gqa=True)
        return out.transpose(1, 2)

    return call


def check_flash(dev):
    """Small shapes and mask variants; then gemma2-2b's heads (H = 8,
    Hkv = 4, dh = 256, scale 1/16, softcap 50) at T = S = 8,192 for a
    local (window 4,096) and a global layer in f32 and bf16, against the
    plain version and timed; then the bf16 kernel alone at the path's
    T = S = 32,768 (the plain version's f32 logits would be 34 GB).  f32
    runs the CUDA-core kernel and bf16 the tensor-core one; every call
    is held to have launched its dtype's kernel.  Each 8,192 and 32,768
    row is timed beside compiled ``flex_attention`` (softcap score_mod,
    causal or window block mask), whose output is held to the kernel's
    within the dtype's tolerance; the softcap-free global layer at
    32,768 is also timed beside ``F.scaled_dot_product_attention``.
    Returns the kernel lines: ``flash_attention`` reports the 8,192
    global layer in f32, ``flash_attention_wgmma`` the same in bf16
    with its 32,768 rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(13)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    kernel_of = {torch.float32: "flash_attention",
                 torch.bfloat16: "flash_attention_wgmma"}
    flex = flex_library(dev)

    def qkv(b, t, s, h, hk, d, dt):
        return [torch.randn(*shape, generator=gen, device=dev).to(dt)
                for shape in ((b, t, h, d), (b, s, hk, d), (b, s, hk, d))]

    def run(x, **kw):
        """ops.flash_attention, held to have launched x's kernel once."""
        name = kernel_of[x[0].dtype]
        before = dict(ops.LAUNCHES)
        out = ops.flash_attention(*x, **kw)
        if dict(ops.LAUNCHES) != {**before, name: before[name] + 1}:
            raise AssertionError(f"flash_attention on {x[0].dtype} did not "
                                 f"launch {name} alone")
        return out

    for shape in ((1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64),
                  (1, 200, 264, 4, 1, 32), (2, 64, 512, 8, 4, 128),
                  (1, 77, 130, 8, 4, 256)):
        for dt, tol in tols.items():
            x = qkv(*shape, dt)
            close(run(x).float(), ref.flash_attention_ref(*x).float(), tol)
    for dt, tol in tols.items():
        x = qkv(2, 192, 192, 4, 2, 64, dt)
        for window, softcap, causal in ((64, None, True), (-1, 50.0, True),
                                        (32, 30.0, True), (-1, None, False),
                                        (65, 50.0, False)):
            kw = dict(window=window, softcap=softcap, causal=causal)
            close(run(x, **kw).float(),
                  ref.flash_attention_ref(*x, **kw).float(), tol)
    layers = {"local": dict(window=4096, softcap=50.0, scale=1 / 16),
              "global": dict(window=-1, softcap=50.0, scale=1 / 16)}
    rows = {}

    def library(x, name, got, tol):
        """flex_attention's time on x, its output held to the kernel's."""
        lib_ms = cuda_ms(lambda: flex(x, name), reps=3, warm=1)
        lib_err = close(flex(x, name).float(), got.float(), tol)
        return {"library_ms": lib_ms, "library_max_abs_diff": lib_err}

    for dt, tol in tols.items():
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        x = qkv(1, 8192, 8192, 8, 4, 256, dt)
        for name, kw in layers.items():
            got = run(x, **kw)
            err = close(got.float(), ref.flash_attention_ref(*x, **kw).float(),
                        tol)
            reps = 20 if dt == torch.bfloat16 else 5
            ms = cuda_ms(lambda: ops.flash_attention(*x, **kw), reps=reps,
                         warm=1)
            plain_ms = cuda_ms(lambda: ref.flash_attention_ref(*x, **kw),
                               reps=2, warm=1)
            b_ms, by = flash_bound(1, 8192, 8192, 8, 4, 256,
                                   x[0].element_size(), kw["window"])
            rows[(8192, name, dname)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by,
                **library(x, name, got, tol),
                "shape": f"B=1 T=S=8192 H=8 Hkv=4 dh=256 {name} {dname}"}
            if dt == torch.float32:
                rows[(8192, name, dname)]["bound_all_f32_ms"] = flash_bound(
                    1, 8192, 8192, 8, 4, 256, 4, kw["window"],
                    all_f32=True)[0]
            del got
        del x
        torch.cuda.empty_cache()
    x = qkv(1, 32768, 32768, 8, 4, 256, torch.bfloat16)
    for name, kw in layers.items():
        got = run(x, **kw)
        ms = cuda_ms(lambda: ops.flash_attention(*x, **kw), reps=10, warm=1)
        b_ms, by = flash_bound(1, 32768, 32768, 8, 4, 256, 2, kw["window"])
        rows[(32768, name, "bf16")] = {
            "ms": ms, "bound_ms": b_ms, "bound_by": by,
            **library(x, name, got, 2e-2),
            "shape": f"B=1 T=S=32768 H=8 Hkv=4 dh=256 {name} bf16"}
        del got
    nocap = dict(window=-1, scale=1 / 16)
    qt, kt, vt = (y.transpose(1, 2) for y in x)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True, scale=1 / 16)

    ms = cuda_ms(lambda: ops.flash_attention(*x, **nocap), reps=10, warm=1)
    lib_ms = cuda_ms(sdpa, reps=10, warm=2)
    diff = float((run(x, **nocap).float()
                  - sdpa().transpose(1, 2).float()).abs().max())
    b_ms, by = flash_bound(1, 32768, 32768, 8, 4, 256, 2, -1)
    rows[(32768, "global-nocap", "bf16")] = {
        "ms": ms, "library_ms": lib_ms, "library_max_abs_diff": diff,
        "bound_ms": b_ms, "bound_by": by,
        "shape": "B=1 T=S=32768 H=8 Hkv=4 dh=256 global, no softcap, bf16"}
    del x, qt, kt, vt
    torch.cuda.empty_cache()
    for r in rows.values():
        lib = "SDPA" if "no softcap" in r["shape"] else "flex_attention"
        all_f32 = (f", all in f32 {r['bound_all_f32_ms']:.3f} ms"
                   if "bound_all_f32_ms" in r else "")
        log(f"flash_attention [{r['shape']}]: {r['ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms{all_f32}, plain {r.get('plain_ms')}, "
            f"{lib} {r['library_ms']:.3f} ms (max abs diff "
            f"{r['library_max_abs_diff']:.3e}), max abs err "
            f"{r.get('max_abs_err')}")
    wgmma = dict(rows[(8192, "global", "bf16")])
    wgmma["at_32k"] = {k[1]: {"ms": r["ms"], "bound_ms": r["bound_ms"],
                              "library_ms": r["library_ms"]}
                       for k, r in rows.items() if k[0] == 32768}
    return {"flash_attention": rows[(8192, "global", "f32")],
            "flash_attention_wgmma": wgmma}


# the zoo's backward kernels against their plain versions, each
# gradient relative to its largest magnitude: f32 as row 7's 5e-5 (f32
# sums over up to 655,360 terms in another order than the plain
# version's), bf16 2e-2 (bf16's own rounding of the outputs)
NEW_BWD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}


def close_rel(got, want, what: str) -> tuple[float, float]:
    """(the largest error of the gradients ``got`` against ``want``
    relative to each one's largest magnitude, the largest absolute
    error); raises above ``NEW_BWD_TOL`` of the dtype, for a shape or
    dtype mismatch, or for a value that is not finite."""
    import torch
    torch.cuda.synchronize()
    rel_worst = abs_worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or \
                not torch.isfinite(g).all():
            raise AssertionError(f"{what}: gradient {i} {tuple(g.shape)} "
                                 f"{g.dtype} vs {tuple(w.shape)} {w.dtype}, "
                                 f"or not finite")
        tol = NEW_BWD_TOL[str(w.dtype).split(".")[-1]]
        err = float((g.double() - w.double()).abs().max()) if g.numel() \
            else 0.0
        rel = err / (float(w.double().abs().max()) or 1.0) if g.numel() \
            else 0.0
        if rel > tol:
            raise AssertionError(f"{what}: gradient {i} off by {rel:.3e} of "
                                 f"its largest magnitude (tol {tol})")
        rel_worst, abs_worst = max(rel_worst, rel), max(abs_worst, err)
    return rel_worst, abs_worst


def repeat_bitwise(fn, first, what: str) -> None:
    """Raises unless a second ``fn()`` gives ``first`` bit for bit."""
    import torch
    again = fn()
    again = again if isinstance(again, tuple) else (again,)
    first = first if isinstance(first, tuple) else (first,)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{what} is not bitwise repeatable")


def counted(name: str, fn):
    """``fn()``, held to have launched kernel ``name`` once."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    out = fn()
    if dict(ops.LAUNCHES) != {**before, name: before[name] + 1}:
        raise AssertionError(f"{name} was not launched alone, once")
    return out


# the warp-pipelined backward's edges (B, F, D, feats' offset in
# elements into a flat buffer): one sample, strips of 16 rows and one
# pass of 32 (F = 33 writes straight to device memory), n8 tiles and
# 32-byte column steps, rows that are not 16-byte multiples, a base that
# is not 16-byte aligned; B one past a whole grid of warps is added per
# card (4 to 16 warps an SM)
DOT_BWD_EDGES = ((1, 27, 64, 0), (50, 16, 64, 0), (50, 17, 64, 0),
                 (50, 32, 64, 0), (50, 33, 64, 0), (50, 27, 8, 0),
                 (50, 27, 56, 0), (50, 27, 72, 0), (50, 27, 128, 0),
                 (300, 27, 63, 0), (9, 27, 64, 1), (5, 27, 63, 1))


def check_dot_interact_bwd(dev):
    """Small shapes (F = 1 and 2, D = 63) and DOT_BWD_EDGES, then
    DLRM-RM2's train_batch (B = 65,536, F = 27, D = 64) in bf16 (the
    path's dtype) and f32, against ``ref.dot_interact_bwd_ref``, bitwise
    repeats.  The library time is the same function in the inputs' dtype
    by torch ops: dout placed into G, then ``torch.bmm(G + G^T, X)``."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(21)

    def inputs(b, f, d, dt, offset=0):
        flat = 0.3 * torch.randn(offset + b * f * d, generator=gen,
                                 device=dev)
        x = flat.to(dt)[offset:].view(b, f, d)
        g = torch.randn(b, f * (f - 1) // 2, generator=gen,
                        device=dev).to(dt)
        return g, x

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = ((7, 13, 32, 0), (5, 27, 63, 0), (3, 1, 4, 0), (4, 2, 8, 0),
             (33, 27, 64, 0), *DOT_BWD_EDGES,
             *((sms * w + 1, 27, 64, 0) for w in (4, 8, 12, 16)))
    t0 = time.perf_counter()
    for b, f, d, offset in cases:
        for dt in (torch.float32, torch.bfloat16):
            g, x = inputs(b, f, d, dt, offset)
            what = f"dot_interact_bwd {(b, f, d, dt)} offset {offset}"
            got = counted("dot_interact_bwd",
                          lambda: ops.dot_interact_bwd(g, x))
            close_rel((got,), (ref.dot_interact_bwd_ref(g, x),), what)
            repeat_bitwise(lambda: ops.dot_interact_bwd(g, x), got, what)
    log(f"dot_interact_bwd: {len(cases)} small and edge shapes x 2 dtypes "
        f"within tol of the plain version, bitwise repeats "
        f"({time.perf_counter() - t0:.1f}s)")
    rows = {}
    b, f, d = 65_536, 27, 64
    iu, ju = torch.tril_indices(f, f, offset=-1, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        g, x = inputs(b, f, d, dt)
        got = ops.dot_interact_bwd(g, x)
        rel, err = close_rel((got,), (ref.dot_interact_bwd_ref(g, x),),
                             f"dot_interact_bwd B={b} {dt}")
        repeat_bitwise(lambda: ops.dot_interact_bwd(g, x), got,
                       f"dot_interact_bwd B={b} {dt}")
        ms = cuda_ms(lambda: ops.dot_interact_bwd(g, x), reps=20)
        plain_ms = cuda_ms(lambda: ref.dot_interact_bwd_ref(g, x), reps=5)

        def library():
            m = torch.zeros((b, f, f), dtype=dt, device=dev)
            m[:, iu, ju] = g
            return torch.bmm(m + m.mT, x)

        lib_ms = cuda_ms(library, reps=5)
        esize = x.element_size()
        p = f * (f - 1) // 2
        nbytes = esize * (2.0 * b * f * d + b * p)
        flops = 2.0 * b * f * f * d
        b_ms, by = (bound(nbytes, flops, PEAK_BF16_S)
                    if dt == torch.bfloat16
                    else bound(nbytes, 0.0, tf32x3_ops=flops))
        name = "bf16" if dt == torch.bfloat16 else "f32"
        rows[name] = {"max_abs_err": err, "rel_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": by, "library_ms": lib_ms,
                      "shape": f"B={b} F={f} D={d} {name}"}
        del g, x, got
    for r in rows.values():
        log(f"dot_interact_bwd [{r['shape']}]: rel err {r['rel_err']:.3e} "
            f"(max abs {r['max_abs_err']:.3e}), bitwise repeat; "
            f"{r['ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.2f} % of "
            f"the bound (plain {r['plain_ms']:.4f}, G + bmm "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
    line = dict(rows["bf16"])
    line["f32"] = {k: rows["f32"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                             "max_abs_err")}
    return line


def check_cin_bwd(dev):
    """Small shapes (D = 1, a ragged last column block, m = 64, a last
    channel tile short of h), B = 4,096 (columns cut into parts), then
    xDeepFM's train_batch layers,
    B = 65,536, m = 39, D = 10, H_out = 200, at Hp = 39 (x_prev is x0)
    and Hp = 200, against ``ref.cin_layer_bwd_ref``, bitwise repeats.
    The kernel line reports Hp = 200; the library time is the einsum
    composition on the same inputs in 8 chunks of 8,192 samples (whole,
    Z and T would take 41 GB)."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(22)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    def args_of(b, hp, m, d, ho, shared=False):
        k = hp * m
        x0 = r(b, m, d)
        xp = x0 if shared else r(b, hp, d)
        return (r(b, ho, d), r(ho, k, scale=(2.0 / (ho + k)) ** 0.5), xp,
                x0)

    # the last two: the dx kernel's last channel tile short of its three
    # h at D = 1, and m = 64 with the columns cut into three parts
    for shape in ((5, 8, 12, 4, 16), (3, 7, 5, 1, 41), (8, 39, 39, 10, 200),
                  (13, 3, 64, 5, 7), (4096, 39, 39, 10, 200),
                  (257, 17, 39, 1, 200), (4096, 5, 64, 3, 100)):
        a = args_of(*shape)
        got = counted("cin_layer_bwd", lambda: ops.cin_layer_bwd(*a))
        close_rel(got, ref.cin_layer_bwd_ref(*a), f"cin_layer_bwd {shape}")
    rows = {}
    b, m, d, ho = 65_536, 39, 10, 200
    for hp in (39, 200):
        a = args_of(b, hp, m, d, ho, shared=hp == m)
        got = ops.cin_layer_bwd(*a)
        rel, err = close_rel(got, ref.cin_layer_bwd_ref(*a),
                             f"cin_layer_bwd B={b} Hp={hp}")
        repeat_bitwise(lambda: ops.cin_layer_bwd(*a), got,
                       f"cin_layer_bwd B={b} Hp={hp}")
        ms = cuda_ms(lambda: ops.cin_layer_bwd(*a), reps=2, warm=1)
        plain_ms = cuda_ms(lambda: ref.cin_layer_bwd_ref(*a), reps=1,
                           warm=0)
        lib_ms = cuda_ms(lambda: ref.cin_layer_bwd_ref(
            *a, chunk_elems=8192 * hp * m * d), reps=1, warm=0)
        k, n = hp * m, b * d
        # read dz, w, x_prev and x0 (one tensor at Hp = m) once; write dw,
        # dx_prev and dx0 once
        nbytes = 4.0 * (n * ho + ho * k + (0 if hp == m else n * hp)
                        + n * m + ho * k + n * hp + n * m)
        # dw and T = w^T dz (2 Ho k a column each) in 3xTF32 on the
        # tensor cores; Z (k) and T's two contractions into dx_prev and
        # dx0 (2 k each) in f32
        products, rest = n * 4.0 * ho * k, n * 5.0 * k
        b_ms, by = bound(nbytes, rest, tf32x3_ops=products)
        rows[hp] = {"max_abs_err": err, "rel_err": rel, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": lib_ms,
                    "bound_all_f32_ms": bound(nbytes, products + rest)[0],
                    "shape": f"B={b} Hp={hp} m={m} D={d} H_out={ho} f32"}
        del a, got
        torch.cuda.empty_cache()
    for row in rows.values():
        log(f"cin_layer_bwd [{row['shape']}]: rel err {row['rel_err']:.3e} "
            f"(max abs {row['max_abs_err']:.3e}), bitwise repeat; "
            f"{row['ms']:.4f} ms, {100 * row['bound_ms'] / row['ms']:.2f} % "
            f"of the bound (plain {row['plain_ms']:.4f}, einsums in 8 "
            f"chunks {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"by {row['bound_by']}, all in f32 "
            f"{row['bound_all_f32_ms']:.4f})")
    return rows[200]


def flash_bwd_bound(b, t, s, h, hk, dh, esize, window, causal=True,
                    all_f32=False):
    """q, k, v, the output and dO read once, dq, dk, dv written once; 8 dh
    flops per admitted (query, key) pair and head (dq, dk, dv, dP), on the
    tensor cores: bf16 at its peak, f32 as 3xTF32 (``all_f32``: at the
    CUDA cores' f32 peak instead, which the log prints beside it)."""
    nbytes = esize * (4.0 * b * t * h * dh + 2.0 * b * s * hk * dh
                      + b * t * h * dh + 2.0 * b * s * hk * dh)
    ops_n = 8.0 * dh * b * h * attention_pairs(t, s, causal, window)
    if esize == 2:
        return bound(nbytes, ops_n, PEAK_BF16_S)
    if all_f32:
        return bound(nbytes, ops_n)
    return bound(nbytes, 0.0, tf32x3_ops=ops_n)


def flex_backward_ms(dev, x, dout, window):
    """``flex_attention`` compiled with gemma2's softcap score_mod and the
    causal (or causal window) block mask: the time of its backward alone
    (the forward run once, its graph kept), or the reason it fails."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def softcap(score, b, h, q_idx, kv_idx):
        return 50.0 * torch.tanh(score / 50.0)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx
        if window > 0:
            ok = ok & (q_idx - kv_idx < window)
        return ok

    try:
        t, s = x[0].shape[1], x[1].shape[1]
        block = create_block_mask(mask_mod, None, None, t, s, device=dev)
        flex = torch.compile(flex_attention, dynamic=False)
        q, k, v = (y.detach().transpose(1, 2).requires_grad_(True)
                   for y in x)
        out = flex(q, k, v, score_mod=softcap, block_mask=block,
                   scale=1 / 16, enable_gqa=True)
        g = dout.transpose(1, 2)
        return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                   retain_graph=True),
                       reps=3, warm=1), None
    except Exception as e:  # a compile failure is recorded, not fatal
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


# the bf16 backward against the f32 reference (``flash_bwd_f32_distance``):
# each gradient's ||err|| / ||want|| and the worst (b, position, head)
# row's, at the train_4k layers.  Set between the sound kernel's largest
# readings and those of faults planted in throwaway copies of the kernel
# (P or dS times 1.1, or P times 1.02, for the later half of the keys),
# on an H100: sound rel 2.30e-3 to 2.37e-3, rows up to 5.07e-3 (the
# plain version 1.67e-3 and 2.6e-3); P x 1.02 rel from 4.02e-3, rows
# from 2.05e-2; x 1.1 rel from 1.67e-2, rows from 9.48e-2, so each
# faulty gradient fails both limits.  The 2e-2 check against the plain
# version passed 38 of those 40 faulty gradients (not dq at window 1,024)
FLASH_BWD_F32_REL_TOL, FLASH_BWD_F32_ROW_TOL = 3.2e-3, 1.2e-2
BWD_ROW_FLOOR = 1e-2


def flash_bwd_f32_distance(grads: dict, x, **kw) -> dict:
    """Each (dq, dk, dv) in ``grads`` (name -> the three gradients) against
    ``ref.flash_attention_bwd_ref`` of ``x`` = (dout, q, k, v, out) upcast
    to f32 (TF32 off; the kernel's function in f32): {name: {"dq" | "dk" |
    "dv": {"rel": ||got - want|| / ||want||, "row": the largest over the
    (b, position, head) rows of dh of the same ratio}}}.  In causal
    attention the first keys' dk and dv are many times the later ones',
    so the row ratio sees a fault in late kv tiles that a tolerance
    relative to the largest magnitude cannot.  A row's norm is floored at
    BWD_ROW_FLOOR of the rows' root mean square: dq's first row is 0 (one
    key, dP = D), and the kernel's is its rounding."""
    import torch
    from repro_torch.kernels import ref

    want = ref.flash_attention_bwd_ref(*(y.float() for y in x), **kw)
    dist = {}
    for n, got in grads.items():
        dist[n] = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            d = g.float() - w
            wn = w.norm(dim=-1)
            floor = BWD_ROW_FLOOR * float(wn.square().mean().sqrt())
            row = d.norm(dim=-1) / wn.clamp(min=floor)
            dist[n][g_name] = {"rel": float(d.norm() / w.norm()),
                               "row": float(row.max())}
            del d, wn, row
    return dist


def check_flash_bwd_f32(label: str, dist: dict) -> dict:
    """Logs each backward's distance from the f32 reference (the kernel's
    beside the plain version's, which rounds only its outputs to bf16) and
    raises unless each of the kernel's gradients is within
    FLASH_BWD_F32_REL_TOL and FLASH_BWD_F32_ROW_TOL."""
    log(f"{label} vs f32 reference: " + "; ".join(
        f"{n} " + ", ".join(f"{g} rel {d['rel']:.3e} row {d['row']:.3e}"
                            for g, d in grads.items())
        for n, grads in dist.items())
        + f" (kernel tol rel {FLASH_BWD_F32_REL_TOL}, row "
          f"{FLASH_BWD_F32_ROW_TOL})")
    got = dist["kernel"]
    if not all(d["rel"] <= FLASH_BWD_F32_REL_TOL
               and d["row"] <= FLASH_BWD_F32_ROW_TOL for d in got.values()):
        raise AssertionError(f"{label}: the kernel is {got} from the f32 "
                             f"reference")
    return got


def check_flash_bwd(dev):
    """Small shapes and every mask variant (causal, non-causal, window,
    softcap, GQA groups of 1 to 16, ragged T and S, a window edge inside
    a tile, dh 8 to 256) in f32 and bf16; then the
    train_4k layers (B = 1, T = S = 4,096): gemma2-2b's heads (8 on 4, dh
    256, scale 1/16, softcap 50) global, with a 1,024 window (< T; the
    path's 4,096 window equals T) and at a ragged T = S = 4,000, in bf16
    and f32; glm4-9b's (32 on 2, dh 128), minicpm-2b's (36, dh 64),
    granite-moe-1b-a400m's (16 on 8, dh 64) and olmoe-1b-7b's (16, dh
    128) in bf16; each against ``ref.flash_attention_bwd_ref`` with a
    bitwise repeat, and the bf16 train_4k layers also against the f32 reference
    (``check_flash_bwd_f32``).  The kernel line reports gemma2's global
    layer in bf16 (its ``f32`` entry the same layer in f32), each timed
    beside compiled ``flex_attention``'s backward in the same dtype, or
    with the reason that fails."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(23)

    def inputs(b, t, s, h, hk, dh, dt, **kw):
        q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, t, h, dh), (b, s, hk, dh),
                                 (b, s, hk, dh)))
        out = ops.flash_attention(q, k, v, **kw)
        dout = torch.randn(out.shape, generator=gen, device=dev).to(dt)
        return dout, q, k, v, out

    f32_refs = {}

    def check(shape, dt, label=None, **kw):
        x = inputs(*shape, dt, **kw)
        got = counted("flash_attention_bwd",
                      lambda: ops.flash_attention_bwd(*x, **kw))
        plain = ref.flash_attention_bwd_ref(*x, **kw)
        errs = close_rel(got, plain, f"flash_attention_bwd {shape} {dt} {kw}")
        repeat_bitwise(lambda: ops.flash_attention_bwd(*x, **kw), got,
                       f"flash_attention_bwd {shape} {dt} {kw}")
        if label is not None and dt == torch.bfloat16:
            f32_refs[label] = check_flash_bwd_f32(
                f"flash_attention_bwd [{label} {shape} bf16]",
                flash_bwd_f32_distance({"kernel": got, "plain": plain}, x,
                                       **kw))
        return errs, x

    for dt in (torch.float32, torch.bfloat16):
        # dh 100 (f32) and 104 (bf16: the forward's TMA loads need a
        # multiple of 8) fill part of the kernel's 128-wide rows
        odd = 100 if dt == torch.float32 else 104
        for shape in ((1, 32, 32, 2, 2, 64), (2, 77, 77, 4, 2, 16),
                      (1, 100, 130, 4, 1, 128), (2, 64, 96, 8, 4, 256),
                      (1, 45, 45, 3, 3, odd), (1, 200, 200, 16, 1, 8)):
            check(shape, dt)
        check((1, 130, 190, 2, 2, 64), dt, window=70)
        for kw in (dict(window=16), dict(softcap=50.0, scale=0.3),
                   dict(window=40, softcap=30.0), dict(causal=False),
                   dict(causal=False, window=33, softcap=50.0)):
            check((2, 150, 150, 4, 2, 64), dt, **kw)
    path = dict(softcap=50.0, scale=1 / 16)
    rows = {}
    cases = [("gemma2 global", (1, 4096, 4096, 8, 4, 256), path),
             ("gemma2 window 1024", (1, 4096, 4096, 8, 4, 256),
              dict(path, window=1024)),
             ("gemma2 ragged T=S=4000", (1, 4000, 4000, 8, 4, 256), path)]
    for dt in (torch.bfloat16, torch.float32):
        for label, shape, kw in cases:
            (rel, err), x = check(shape, dt, label, **kw)
            rows[(label, dt)] = (rel, err, shape, kw)
            if label == "gemma2 global":
                dname = "bf16" if dt == torch.bfloat16 else "f32"
                ms = cuda_ms(lambda: ops.flash_attention_bwd(*x, **kw),
                             reps=3, warm=1)
                plain_ms = cuda_ms(
                    lambda: ref.flash_attention_bwd_ref(*x, **kw), reps=2,
                    warm=1)
                b_ms, by = flash_bwd_bound(*shape, x[1].element_size(), -1)
                t_lib = time.perf_counter()
                lib_ms, lib_err = flex_backward_ms(dev, x[1:4], x[0], -1)
                rows[("line", dname)] = {
                    "max_abs_err": err, "rel_err": rel, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": lib_ms, "library_error": lib_err,
                    "library_s": time.perf_counter() - t_lib,
                    "shape": f"B=1 T=S=4096 H=8 Hkv=4 dh=256 causal, "
                             f"softcap 50, {dname}"}
                if dname == "f32":
                    rows[("line", dname)]["bound_all_f32_ms"] = \
                        flash_bwd_bound(*shape, 4, -1, all_f32=True)[0]
            del x
            torch.cuda.empty_cache()
    for label, shape in (("glm4-9b heads", (1, 4096, 4096, 32, 2, 128)),
                         ("minicpm-2b heads", (1, 4096, 4096, 36, 36, 64)),
                         ("granite-moe-1b-a400m heads",
                          (1, 4096, 4096, 16, 8, 64)),
                         ("olmoe-1b-7b heads",
                          (1, 4096, 4096, 16, 16, 128))):
        (rel, err), x = check(shape, torch.bfloat16, label)
        ms = cuda_ms(lambda: ops.flash_attention_bwd(*x), reps=2, warm=1)
        b_ms, by = flash_bwd_bound(*shape, 2, -1)
        log(f"flash_attention_bwd [{label} {shape} bf16]: rel err {rel:.3e}, "
            f"bitwise repeat; {ms:.3f} ms, bound {b_ms:.4f} by {by} "
            f"({100 * b_ms / ms:.2f} %)")
        del x
        torch.cuda.empty_cache()
    for (label, dt), v in rows.items():
        if label != "line":
            log(f"flash_attention_bwd [{label} {v[2]} {dt} {v[3]}]: rel err "
                f"{v[0]:.3e} (max abs {v[1]:.3e}), bitwise repeat")
    for dname in ("bf16", "f32"):
        r = rows[("line", dname)]
        lib = (f"flex_attention backward {r['library_ms']:.3f} ms"
               if r["library_ms"] is not None
               else f"flex_attention backward: {r['library_error']}")
        lib += f", compiled and timed in {r['library_s']:.1f}s"
        all_f32 = (f", all in f32 {r['bound_all_f32_ms']:.4f}"
                   if dname == "f32" else "")
        log(f"flash_attention_bwd [{r['shape']}]: rel err "
            f"{r['rel_err']:.3e} (max abs {r['max_abs_err']:.3e}); "
            f"{r['ms']:.3f} ms, {100 * r['bound_ms'] / r['ms']:.2f} % of "
            f"the bound (plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}{all_f32}; {lib})")
    line = dict(rows[("line", "bf16")])
    line["f32"] = {k: rows[("line", "f32")][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_all_f32_ms",
                             "library_ms", "library_error", "max_abs_err")}
    line["f32_ref"] = f32_refs
    return line


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
    b = len(res.valid)
    g_n, _, cap = p_host.shape
    p = torch.full((g_n, b, cap), cap, dtype=torch.int32)
    ck = torch.zeros((g_n, b, cap))
    p[:, :m] = torch.from_numpy(p_host.astype(np.int32))
    ck[:, :m] = torch.from_numpy(ck_host.astype(np.float32))
    dec = res.decisions.long().cpu()
    rows = torch.arange(b) * torch.from_numpy(res.valid > 0).long()
    want = ref.cascade_truncate_ref(
        p, ck, pipe._g_of.cpu()[dec], rows, pipe._n3_of.cpu()[dec],
        expose=pipe._expose) * torch.from_numpy(res.valid)
    if not torch.equal(res.revenue.cpu(), want):
        raise AssertionError("served revenue differs from the plain "
                             "truncation on the same tables")


WINDOW_KERNELS = ("cascade_truncate", "target_attention", "embedding_bag")
WINDOW_FIELDS = ("decisions", "revenue", "spend", "downgraded", "flops",
                 "lam_after")


def graph_report(stack) -> None:
    """Print the captures: each scoring program's per-graph capture ms
    and the memory its pool reserved, each window bucket's."""
    src, pipe = stack.source, stack.pipeline
    rep = {"scoring": {}, "buckets": {}}
    for i, sp in enumerate(src.programs):
        progs = {**sp.models, "tables/compact": sp.tables}
        rep["scoring"][i] = {
            "capture_ms": {k: round(v.capture_ms, 3)
                           for k, v in progs.items()},
            "pool_gb": sum(v.pool_bytes for v in progs.values()) / 1e9}
    for key, wp in pipe._programs.items():
        rep["buckets"][str(key)] = {
            "capture_ms": {"window/main": round(wp.main.capture_ms, 3),
                           "window/dual": round(wp.dual.capture_ms, 3)},
            "pool_gb": (wp.main.pool_bytes + wp.dual.pool_bytes) / 1e9}
    for what, rows in rep.items():
        for k, v in rows.items():
            log(f"graphs, {what} {k}: capture ms {v['capture_ms']}, pool "
                f"{v['pool_gb']:.3f} GB")


def check_captured_vs_eager(stack) -> None:
    """The same chunks through the captured window programs and through
    ``graphs=False`` (the same programs run eagerly), at a pinned price:
    decisions, revenue, spend, downgrades, FLOPs and the published price
    bit for bit, on both warm buckets; and the scoring graphs' stage
    scores against eager ``score_slab`` on the same batch."""
    import torch
    from repro_torch.serving.pipeline import ServingPipeline

    src, pipe = stack.source, stack.pipeline
    eager = ServingPipeline(src.universe, pipe.reward_params,
                            pipe.reward_cfg, stack.budget, graphs=False,
                            device=stack.device)
    lam = float(pipe.lam)
    for t, n in ((2000, 512), (2001, 1536)):
        chunk = src.window(t, n)
        c0 = pipe.compile_count()
        got, want = (p.serve_window(chunk.ctx, chunk.rows,
                                    tables=chunk.tables, lam=lam,
                                    update_lam=False, ready=chunk.ready)
                     for p in (pipe, eager))
        torch.cuda.synchronize()
        if pipe.compile_count() != c0:
            raise AssertionError(f"bucket {got.bucket} was not warm")
        for name in WINDOW_FIELDS:
            if not torch.equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"captured window ({n} requests) "
                                     f"differs from eager in {name}")
    sp = src.programs[0]
    ub = {k: v for k, v in sp.inputs.items() if k != "clicks"}
    ref_scores = src.score_slab(ub)
    torch.cuda.synchronize()
    for name, prog in sp.models.items():
        if not torch.equal(prog.out["scores"], ref_scores[name]):
            err = (prog.out["scores"] - ref_scores[name]).abs().max()
            raise AssertionError(f"scoring graph {name} differs from eager "
                                 f"score_slab (max abs err {float(err)})")
    log(f"captured == eager, bitwise, at pinned lambda {lam:.6e}: windows "
        f"of 512 and 1,536 requests ({', '.join(WINDOW_FIELDS)}); scoring "
        f"graphs == eager score_slab for {', '.join(sp.models)}")


def check_no_sync(stack) -> None:
    """Steady-state windows (warm buckets, prefetch=0) served under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync inside
    ``serve_window`` raises."""
    import torch
    from repro_torch.serving.stream import run_stream

    pipe = stack.pipeline
    serve_window = pipe.serve_window

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return serve_window(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    pipe.serve_window = checked
    try:
        st = run_stream(pipe, [512, 1536], stack.source, prefetch=0)
    finally:
        del pipe.serve_window
    torch.cuda.synchronize()
    if any(st.compiles):
        raise AssertionError(f"steady-state windows captured: "
                             f"{st.compiles}")
    log("no host sync inside 2 steady-state windows (512, 1,536 requests) "
        "under set_sync_debug_mode('error')")


def serve_full(args):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.stream import window_table

    log(f"cut: {args.windows} windows of the spike scenario, "
        f"{args.requests} requests a normal window (a serving day has many "
        f"more); weights random from seed {args.seed} (no trained weights "
        f"in the repository)")
    t0 = time.perf_counter()
    stack = serve.build_stack(users=100_000, requests=args.requests,
                              windows=args.windows, scenario="spike",
                              seed=args.seed, device="cuda")
    log(f"stack built in {time.perf_counter() - t0:.1f}s (scoring graphs "
        f"captured): budget {stack.budget:.4e} FLOPs/window, c_max "
        f"{stack.c_max:.4e}, windows {stack.sizes}")
    served = {}
    produce = stack.source.window

    def window(t, n):  # keep window 0 as it was served, to check it
        chunk = produce(t, n)
        if t == 0:
            served[0] = chunk
        return chunk

    stack.source.window = window
    misses = stack.source.cache_misses
    torch.cuda.synchronize()
    ops.reset_launches()
    st = serve.serve(stack, sync=True, prefetch=2)
    launches = dict(ops.LAUNCHES)
    del stack.source.window
    for line in window_table(st):
        log(line)
    chunks = stack.source.cache_misses - misses
    log(f"main-path launches over {len(st.windows)} windows, {chunks} "
        f"scoring chunks: {launches}; compiles {st.compiles}, steady "
        f"{st.steady_compiles}")
    log(f"stream (prefetch 2, synchronised after each window): wall "
        f"{st.wall_s * 1e3:.3f} ms; serve_window ms (to the device's end) "
        f"{[round(x, 3) for x in st.submit_ms]}; stall ms "
        f"{[round(x, 3) for x in st.stall_ms]}; prep ms (producer thread) "
        f"{[round(x, 3) for x in st.prep_ms]}")
    c_min = float(stack.source.chains.costs.min())
    for t, r in enumerate(st.windows):
        spend, lam = float(r.spend), float(r.lam_after)
        rev = float(r.revenue_np.sum())
        # the guard's bound: the budget, or n * c_min when even the
        # cheapest chain for all does not fit (the spike windows)
        cap = max(r.budget, r.n_valid * c_min)
        if not spend <= cap + stack.c_max:
            raise AssertionError(f"window {t}: spend {spend} over "
                                 f"max(budget, n c_min) {cap} + c_max")
        if not math.isfinite(lam):
            raise AssertionError(f"window {t}: lambda {lam} not finite")
        if not rev > 0:
            raise AssertionError(f"window {t}: revenue {rev} not > 0")
        if r.decisions.shape != (len(r.valid),):
            raise AssertionError(f"window {t}: decisions shape")
    if st.steady_compiles != 0:
        raise AssertionError(f"steady-state captures: {st.compiles}")
    n_blocks = -(-stack.source._n_items() // stack.source.item_block)
    want = {"cascade_truncate": len(st.windows),
            "target_attention": n_blocks * chunks, "embedding_bag": chunks}
    expect_chunks = sum(-(-n // stack.source.chunk) for n in stack.sizes)
    for name, cnt in launches.items():
        if cnt != want.get(name, 0) or chunks != expect_chunks:
            raise AssertionError(f"kernel {name} launched {cnt} times on "
                                 f"the serving window path, eager counts "
                                 f"{want} over {expect_chunks} chunks")
    launches = {k: launches[k] for k in WINDOW_KERNELS}
    check_window(stack, served[0], st.windows[0])
    log("window 0 as served: device tables == host builder, revenue == "
        "plain truncation; launches == the eager counts (1 truncation a "
        f"window, {n_blocks} target attention and 1 bag a chunk)")
    check_captured_vs_eager(stack)
    check_no_sync(stack)
    return stack, st, launches


# -- phase 4b: tenants and regions on the same source ------------------------

# a fixed two-region grid-intensity trace (gCO2e/kWh) for the geotenants
# day; region b's intensity doubles in windows 2-3
GEO_CI = ((420.0, 300.0), (380.0, 320.0), (400.0, 620.0), (440.0, 580.0))
GEO_CI_MEAN = 400.0
MULTI_PRICE_FIELDS = WINDOW_FIELDS + ("tenant_spend", "regions",
                                      "region_spend", "tr_spend")


class _Offset:
    """The phase-4 source with window t at ``t + offset``: other arrivals
    (so every chunk is scored, none served from the slab cache)."""

    def __init__(self, src, offset: int):
        self.src, self.offset = src, offset

    def window(self, t, n):
        return self.src.window(t + self.offset, n)


def multi_price_cases(stack) -> dict:
    """The two multi-price pipelines' specs and 4-window day traces:
    ``tenants``, 4 priced tenants whose budgets spread 4x (as ``launch
    .serve --scenario tenants --tenant-mode priced --tenant-spread 4``);
    ``geotenants``, 3 priced tenants x 2 regions built as the JAX
    package's ``--scenario geotenants`` builds them (gram budgets from
    the FLOPs budget at the mean intensity, tenants spread 4x, each
    region capped at 0.6 of the total; scales kappa * CI_r(t)), from
    ``GEO_CI``."""
    import numpy as np
    from repro_torch.core.pfec import kwh_per_flop
    from repro_torch.core.primal_dual import DualDescentConfig
    from repro_torch.launch import serve
    from repro_torch.serving import spec as S
    from repro_torch.serving.stream import TrafficScenario

    n_w = len(GEO_CI)
    tb = serve.tenant_budgets(stack.budget, 4, 4.0)
    g_total = stack.budget * kwh_per_flop() * GEO_CI_MEAN
    tg = serve.tenant_budgets(g_total, 3, 4.0)
    rg = np.full(2, 0.6 * g_total)
    geo_dual = DualDescentConfig(max_iters=300, step_decay=0.98)
    return {
        "tenants": dict(
            spec=S.ConstraintSpec([S.TenantAxis(tuple(tb), priced=True)]),
            sizes=TrafficScenario("tenants", n_w, 512,
                                  n_tenants=4).window_sizes(),
            budgets=[tb] * n_w, scales=[1.0] * n_w, dual_cfg=None),
        "geotenants": dict(
            spec=S.ConstraintSpec([
                S.TenantAxis(tuple(tg), priced=True),
                S.RegionAxis(2, names=("region_a", "region_b"),
                             split="flow"),
                S.GlobalAxis(pricing="carbon")]),
            sizes=TrafficScenario("tenants", n_w, 512,
                                  n_tenants=3).window_sizes(),
            budgets=[np.concatenate([tg, rg])] * n_w,
            scales=[kwh_per_flop() * np.asarray(ci) for ci in GEO_CI],
            dual_cfg=geo_dual)}


def check_multi_price_caps(name, st, case, chains) -> None:
    """Every tenant's and region's spend (the window's, without either)
    within its budget (or the floor of its requests all on the cheapest
    option) plus one option's cost, in the window's cost units (without
    scales, FLOPs); revenue positive, prices finite."""
    import numpy as np
    import torch

    costs = np.asarray(chains.costs, np.float64)
    for t, r in enumerate(st.windows):
        sc = None if case["scales"] is None else case["scales"][t]
        scale = np.atleast_1d(np.asarray(1.0 if sc is None else sc,
                                         np.float64))
        c_max, c_min = costs.max() * scale.max(), costs.min() * scale.min()
        bud = np.atleast_1d(np.asarray(case["budgets"][t], np.float64))
        groups = []
        t_n = 0 if r.tenant_spend is None else len(r.tenant_spend)
        if t_n:
            n_t = r.n_valid // t_n
            groups += [(f"tenant {k}", float(s), bud[k], n_t)
                       for k, s in enumerate(r.tenant_spend.tolist())]
        if r.region_spend is not None:
            counts = np.bincount(r.regions_np, minlength=len(scale))
            groups += [(f"region {k}", float(s), bud[t_n + k], counts[k])
                       for k, s in enumerate(r.region_spend.tolist())]
        if not groups:
            groups = [("window", float(r.spend), bud[0], r.n_valid)]
        for what, spend, b, n in groups:
            cap = max(b, n * c_min) + c_max
            if not spend <= cap:
                raise AssertionError(f"{name} window {t}: {what} spend "
                                     f"{spend} over its cap {cap}")
        if not float(np.sum(r.revenue_np)) > 0:
            raise AssertionError(f"{name} window {t}: no revenue")
        if not bool(torch.isfinite(r.lam_after).all()):
            raise AssertionError(f"{name} window {t}: price not finite")


def check_multi_price_vs_eager(name, pipe, case, src) -> None:
    """Two fresh chunks on the warm bucket through the captured program
    and through ``graphs=False``, at the captured pipeline's price,
    served with windows 1 and 2 of the day (region b's scale doubled in
    the second): every output bit for bit."""
    import torch
    from repro_torch.serving.pipeline import ServingPipeline

    eager = ServingPipeline.from_spec(
        src.universe, pipe.reward_params, pipe.reward_cfg, case["spec"],
        graphs=False, device=pipe.device,
        **({} if case["dual_cfg"] is None else
           {"dual_cfg": case["dual_cfg"]}))
    lam = pipe.lam.clone()
    for k, t in enumerate((1, 2)):
        chunk = src.window(7000 + k, case["sizes"][t])
        c0 = pipe.compile_count()
        got, want = (p.serve_window(
            chunk.ctx, chunk.rows, tables=chunk.tables, ready=chunk.ready,
            lam=lam, update_lam=False, budget=case["budgets"][t],
            cost_scale=case["scales"][t]) for p in (pipe, eager))
        torch.cuda.synchronize()
        if pipe.compile_count() != c0:
            raise AssertionError(f"{name}: bucket {got.bucket} not warm")
        for field in MULTI_PRICE_FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a, b)):
                raise AssertionError(f"{name}: captured window (day "
                                     f"window {t}) differs from eager in "
                                     f"{field}")


def check_multi_price_no_sync(pipe, case, src) -> None:
    import torch

    chunk = src.window(7100, case["sizes"][0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pipe.serve_window(chunk.ctx, chunk.rows, tables=chunk.tables,
                                ready=chunk.ready,
                                budget=case["budgets"][0],
                                cost_scale=case["scales"][0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if res.compiles:
        raise AssertionError("the no-sync window was not warm")


def check_server_slab(stack) -> dict:
    """A materialized ``CascadeServer`` over one full-width slab (512
    users' stage scores and clicks from the phase-4 source): ``serve``
    through the truncation kernel equals the plain per-request oracle
    ``_revenue_requests`` exactly.  Its launch is not a path launch."""
    import numpy as np
    import torch
    from repro_torch.cascade.engine import (CascadeServer,
                                            _revenue_requests, _user_batch)
    from repro_torch.kernels import ops

    src = stack.source
    users = src.arrivals(7200, src.chunk)
    slab = src.world.user_slab(users)
    ub = _user_batch(slab, np.arange(len(users)), stack.device,
                     pad_to=src.chunk)
    scores = {k: v.cpu().numpy() for k, v in src.score_slab(ub).items()}
    clicks = src.world.clicks_slab(users, slab, pad_rows=src.chunk)
    t0 = time.perf_counter()
    server = CascadeServer(scores, src.chains, clicks, expose=src.expose,
                           device=stack.device)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(users), 512)
    dec = rng.integers(0, src.chains.n_chains, 512)
    before = ops.LAUNCHES["cascade_truncate"]
    rev, _ = server.serve(rows, dec)
    if ops.LAUNCHES["cascade_truncate"] != before + 1:
        raise AssertionError("CascadeServer.serve did not launch the "
                             "truncation kernel")
    r = server._ranked
    want = _revenue_requests(
        torch.from_numpy(r.orders), torch.from_numpy(r.ranks),
        torch.from_numpy(np.asarray(clicks, np.float32)),
        torch.from_numpy(server._slots[dec]),
        torch.from_numpy(server._keeps[dec]), torch.from_numpy(rows),
        n_stages=src.chains.n_stages).numpy()
    if not np.array_equal(rev, want):
        raise AssertionError("CascadeServer.serve through the kernel "
                             "differs from the plain oracle")
    log(f"CascadeServer over a 512 x {clicks.shape[1]} slab (built in "
        f"{build_s:.1f}s): serve through cascade_truncate == "
        f"_revenue_requests on 512 requests, revenue {float(rev.sum()):.0f}")


def serve_multi_price(stack) -> dict:
    """Phase 4b: the tenants-priced and geotenants pipelines over the
    phase-4 source, 4 windows each, prefetch 2, synchronised after each
    window, every kernel count reset just before each run and read just
    after it.  Returns {pipeline: launches}."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.serving.stream import run_stream, window_table

    src, base = stack.source, stack.pipeline
    n_blocks = -(-src._n_items() // src.item_block)
    out = {}
    for k, (name, case) in enumerate(multi_price_cases(stack).items()):
        pipe = ServingPipeline.from_spec(
            src.universe, base.reward_params, base.reward_cfg, case["spec"],
            device=stack.device,
            **({} if case["dual_cfg"] is None else
               {"dual_cfg": case["dual_cfg"]}))
        misses = src.cache_misses
        torch.cuda.synchronize()
        ops.reset_launches()
        st = run_stream(pipe, case["sizes"], _Offset(src, 5000 + 100 * k),
                        budget_trace=case["budgets"],
                        scale_trace=case["scales"], prefetch=2,
                        sync=torch.cuda.synchronize)
        launches = dict(ops.LAUNCHES)
        chunks = src.cache_misses - misses
        for line in window_table(st):
            log(f"{name} {line}")
        log(f"{name}: windows {case['sizes']}, wall {st.wall_s * 1e3:.3f} "
            f"ms, serve_window ms {[round(x, 3) for x in st.submit_ms]}, "
            f"stall ms {[round(x, 3) for x in st.stall_ms]}; launches "
            f"{launches} over {chunks} chunks; captures {st.compiles}; "
            f"capture ms " + ", ".join(
                f"{key}: main {wp.main.capture_ms:.1f}, dual "
                f"{wp.dual.capture_ms:.1f}"
                for key, wp in pipe._programs.items()))
        for t, r in enumerate(st.windows):
            if r.tr_spend is not None:
                log(f"{name} window {t}: (T, R) spend "
                    f"{r.tr_spend.tolist()}, regions "
                    f"{[int((r.regions_np == q).sum()) for q in range(2)]}")
        want = {"cascade_truncate": len(st.windows),
                "target_attention": n_blocks * chunks,
                "embedding_bag": chunks}
        if chunks != len(st.windows) or any(
                cnt != want.get(kn, 0) for kn, cnt in launches.items()):
            raise AssertionError(f"{name}: launches {launches} over "
                                 f"{chunks} chunks, eager counts {want}")
        if st.steady_compiles or st.compiles[0] != 2 or any(
                st.compiles[1:]):
            raise AssertionError(f"{name}: captures {st.compiles}")
        check_multi_price_caps(name, st, case, src.chains)
        check_multi_price_vs_eager(name, pipe, case, src)
        check_multi_price_no_sync(pipe, case, src)
        log(f"{name}: caps hold per tenant and region; captured == eager "
            f"bitwise at a pinned price across the budget/scale change; "
            f"no host sync in a steady window")
        profile_served(f"{name} window", src, pipe, 7400 + k,
                       case["sizes"][0], budget=case["budgets"][0],
                       cost_scale=case["scales"][0])
        out[name] = {kn: launches[kn] for kn in WINDOW_KERNELS}
    check_server_slab(stack)
    return out


# -- phase 4c: the CLI's carbon days on the same source ----------------------

CARBON_DAYS = {
    "carbon": ["--ci-trace", "diurnal", "--ci-mean", "450",
               "--carbon-pricing", "carbon"],
    "georegions": ["--geo-offset-h", "8", "--geo-split", "flow"],
    "geotenants": ["--tenants", "3", "--tenant-mode", "priced",
                   "--tenant-spread", "4", "--region-cap-frac", "0.6"],
}
CARBON_FIELDS = ("decisions", "spend", "lam_after", "tenant_spend",
                 "region_spend", "tr_spend", "regions")


def carbon_day_args(name: str, report_dir: str):
    """The CLI's arguments of one day: 4 windows around 512 requests
    (the diurnal curve: 512, 819, 512, 204; 510, 819, 510, 204 in three
    tenant blocks), prefetch 2, the report in ``report_dir``."""
    from repro_torch.launch import serve

    return serve.parser().parse_args(
        ["--scenario", name, "--windows", "4", "--requests", "512",
         "--prefetch", "2", "--carbon-report",
         os.path.join(report_dir, f"{name}.csv"), *CARBON_DAYS[name]])


def check_ledgers(name, day, chains) -> None:
    """The day's ledgers: their requests are the served requests, their
    FLOPs the chain costs of the decisions each region served, recomputed
    exactly, and each entry's gCO2e its kWh at that window's intensity;
    the report CSV exists, with a ``region`` column on a geo day."""
    import numpy as np

    costs = np.asarray(chains.costs, np.float64)
    served = sum(r.n_valid for r in day.stats.windows)
    metered = sum(led.report()["n_requests"] for led in day.ledgers.values())
    if metered != served:
        raise AssertionError(f"{name}: ledgers metered {metered} requests "
                             f"of {served} served")
    for k, (region, led) in enumerate(day.ledgers.items()):
        for t, (e, r) in enumerate(zip(led.entries, day.stats.windows)):
            dec = r.decisions_np
            if r.regions is not None:
                dec = dec[r.regions_np == k]
            flops = float(np.sum(costs[dec]))
            if e.flops != flops or e.n_requests != len(dec):
                raise AssertionError(f"{name} {region} window {t}: ledger "
                                     f"{e.flops} FLOPs for {e.n_requests} "
                                     f"requests, decisions {flops} for "
                                     f"{len(dec)}")
            if (e.ci_g_per_kwh != day.ci[region][t]
                    or e.gco2e != e.kwh * e.ci_g_per_kwh):
                raise AssertionError(f"{name} {region} window {t}: gCO2e "
                                     f"{e.gco2e} is not kWh {e.kwh} x CI "
                                     f"{day.ci[region][t]}")
    with open(day.report) as f:
        header = f.readline()
    want = "region,window," if name != "carbon" else "window,"
    if not header.startswith(want):
        raise AssertionError(f"{name}: report header {header!r}")


def check_carbon_obs(stack, day, report_dir) -> None:
    """The carbon day again, with an ``Obs`` attached (metrics, tracer and
    the JSONL flight log): decisions, spends and the price after each
    window bit for bit the obs-free run's; then one more warm window of
    its pipeline, with the ledger and obs attached, under
    ``set_sync_debug_mode("error")``."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.obs import Obs, WindowEventLog

    obs = Obs(events=WindowEventLog(os.path.join(report_dir,
                                                 "carbon.windows.jsonl")))
    args = carbon_day_args("carbon", report_dir)
    args.carbon_report = os.path.join(report_dir, "carbon_obs.csv")
    src = _Offset(stack.source, 8000)
    again = serve.carbon_day(stack, args, source=src, obs=obs)
    for t, (a, b) in enumerate(zip(day.stats.windows, again.stats.windows)):
        for field in CARBON_FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x, y)):
                raise AssertionError(f"carbon window {t}: obs on differs "
                                     f"from obs off in {field}")
    with open(obs.events.path) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != 4 or any(r["gco2e"] is None for r in rows):
        raise AssertionError(f"carbon flight log: {rows}")
    pipe = again.pipeline
    chunk = stack.source.window(8900, 512)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pipe.serve_window(chunk.ctx, chunk.rows, tables=chunk.tables,
                                ready=chunk.ready, budget=again.budgets[0],
                                cost_scale=again.scales[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if res.compiles or len(pipe.ledger.entries) != 5:
        raise AssertionError("the no-sync carbon window was not warm or "
                             "not metered")
    spans = sorted({e[0] for e in obs.tracer.events})
    log(f"carbon day with obs == without, bitwise ({', '.join(CARBON_FIELDS)}"
        f"); {len(rows)} flight-log rows, spans {spans}; a warm window with "
        f"the ledger and obs attached served with no host sync")


def build_launches(cfg, item_block: int = 256) -> dict:
    """The kernel launches of ``experiments.build_serving_stack(cfg)``
    loading its experiment from the cache: the server's stage scores
    over the evaluation users (DIN's item blocks, YDNN's bag)."""
    return {"target_attention": -(-cfg.world.n_items // item_block),
            "embedding_bag": 1}


def train_launches(cfg, item_block: int = 256) -> dict:
    """The kernel launches of training the experiment of ``cfg`` (a cold
    cache), as phase 9b counts them: a forward and a backward attention
    launch a DIN step, a bag and its backward a YDNN step, the stage
    scores of the evaluation and reward users; and the server's scores."""
    s, blocks = cfg.cascade_steps, -(-cfg.world.n_items // item_block)
    return {"target_attention": 2 * s + 3 * blocks,
            "target_attention_bwd": 2 * s, "embedding_bag": s + 3,
            "embedding_bag_bwd": s}


def build_trained_stack(small: bool = False) -> dict:
    """The CLI's trained stack (``experiments.build_serving_stack(
    serve_config(small=...))``) built on the card into the smoke's
    experiment cache, the counters reset before and read after: the
    launches equal ``train_launches`` (nothing else); returns them with
    the build's wall seconds."""
    import torch
    from repro_torch import experiments as E
    from repro_torch.kernels import ops

    cfg = E.serve_config(small=small)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    exp, server, _, _ = E.build_serving_stack(cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = {k: c for k, c in ops.LAUNCHES.items() if c}
    want = train_launches(cfg)
    if got != want:
        raise AssertionError(f"trained stack (small={small}): launches "
                             f"{got}, want {want}")
    log(f"trained stack (serve_config(small={small}): U={cfg.world.n_users} "
        f"I={cfg.world.n_items} J={exp.chains.n_chains}, cascade "
        f"{cfg.cascade_steps} steps (DIN, DIEN {2 * cfg.cascade_steps}), "
        f"reward model {cfg.reward_steps}) trained on the card in "
        f"{build_s:.2f} s; launches {got}; server over "
        f"{len(exp.ctx_eval)} evaluation users, tables "
        f"{tuple(server.compact.p_sorted.shape)}")
    return {"launches": got, "build_s": build_s}


def check_cli_carbon_day(report_dir) -> dict:
    """The CLI's carbon day end to end, as ``python -m
    repro_torch.launch.serve --source generated --scenario carbon`` serves
    it on the card: the trained full-width stack is built first, into
    the smoke's experiment cache (its training counted on its own); then
    ``serve.main`` loads it from the cache, builds a ``GeneratedSource``
    over a 100,000-user world of it (the source carries the ``Obs``, so
    the table-cache counters and ``chunk_tables`` spans are recorded),
    serves 4 diurnal windows with ``--metrics-out``, ``--trace-out`` and
    ``--profile-dir`` (``torch.profiler`` around the stack's load, the
    reward model's training, the scoring captures and the day) and writes
    every file.  The counters are reset just before and read just after
    each; returns both runs' launches."""
    import torch
    from repro_torch import experiments as E
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    built = build_trained_stack()
    cfg = E.serve_config()
    out = os.path.join(report_dir, "cli")
    prom = os.path.join(out, "serve.prom")
    trace = os.path.join(out, "serve.trace.json")
    prof = os.path.join(out, "prof")
    argv = ["--source", "generated", "--users", "100000", "--scenario",
            "carbon", "--windows", "4", "--requests", "512",
            "--carbon-report", os.path.join(out, "carbon.csv"),
            "--metrics-out", prom, "--trace-out", trace, "--profile-dir",
            prof, "--obs-interval", "2"]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    gc.collect()  # the CLI's stack and its graphs
    torch.cuda.empty_cache()
    sizes = serve.scenario_sizes("carbon", 4, 512)
    chunks = sum(-(-n // 512) for n in sizes)
    blocks = -(-cfg.world.n_items // 256)
    # the server's stage scores, then the source, whose scoring program
    # runs once eagerly on the zero batch before it captures: one chunk
    # more than served
    want = build_launches(cfg)
    want["target_attention"] += blocks * (chunks + 1)
    want["embedding_bag"] += chunks + 1
    want["cascade_truncate"] = len(sizes)
    if rc != 0 or any(c != want.get(k, 0) for k, c in launches.items()):
        raise AssertionError(f"CLI carbon day: exit {rc}, launches "
                             f"{launches}, eager counts {want}")
    lines = open(prom).read().splitlines()
    for line in (f"greenflow_windows_total {len(sizes)}",
                 f"greenflow_table_cache_misses_total {chunks}"):
        if line not in lines:
            raise AssertionError(f"CLI carbon day: no {line!r} in {prom}")
    with open(prom + ".json") as f:
        json.load(f)
    with open(prom + ".windows.jsonl") as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != len(sizes) or any(r["gco2e"] is None for r in rows):
        raise AssertionError(f"CLI carbon day flight log: {rows}")
    with open(trace) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"}
    need = {"chunk_tables", "prep", "stall", "serve", "h2d", "dispatch",
            "dual_update", "block_until_ready", "ledger"}
    if not need <= spans:
        raise AssertionError(f"CLI carbon day: spans {sorted(spans)} lack "
                             f"{sorted(need - spans)}")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    seen = {k: sum(f"{k}_kernel" in name for name in kernels)
            for k in WINDOW_KERNELS}
    if not ({"serve", "dispatch", "window/main"} <= ranges
            and all(seen.values())):
        raise AssertionError(f"CLI carbon day profile: ranges "
                             f"{sorted(ranges)[:20]}, kernels {seen}")
    log(f"CLI carbon day (serve.main --source generated, the trained "
        f"full-width stack from the cache, --metrics-out --trace-out "
        f"--profile-dir): wall {wall_ms:.3f} ms with the stack's load, the "
        f"reward model's training and the profiler; launches {launches} "
        f"over {chunks} chunks, the capture's warm-up chunk and the "
        f"server's scores (== eager); {len(rows)} flight-log rows, {chunks} "
        f"table-cache misses, spans {sorted(spans)}; profiler trace: "
        f"{len(events)} events, {len(kernels)} device kernels, window "
        f"kernels {seen}, host ranges {sorted(ranges & need)}")
    return {"trained stack build": built["launches"],
            "carbon CLI": {k: launches[k] for k in WINDOW_KERNELS},
            "build_s": built["build_s"]}


def serve_carbon_days(stack) -> dict:
    """Phase 4c: the CLI's carbon, georegions and geotenants days
    (``launch.serve.carbon_day``, ``region_day``) over
    the phase-4 source at window offsets of their own, every kernel count
    reset just before each day and read just after it.  Returns {day:
    launches}."""
    import tempfile

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    src = stack.source
    n_blocks = -(-src._n_items() // src.item_block)
    out = {}
    with tempfile.TemporaryDirectory(prefix="carbon-days-") as report_dir:
        days = {}
        for k, name in enumerate(CARBON_DAYS):
            args = carbon_day_args(name, report_dir)
            misses = src.cache_misses
            torch.cuda.synchronize()
            ops.reset_launches()
            day = serve.DAYS[name](stack, args,
                                   source=_Offset(src, 8000 + 100 * k))
            launches = dict(ops.LAUNCHES)
            chunks = src.cache_misses - misses
            st = day.stats
            want = {"cascade_truncate": len(st.windows),
                    "target_attention": n_blocks * chunks,
                    "embedding_bag": chunks}
            expect_chunks = sum(-(-n // src.chunk) for n in st.sizes)
            if chunks != expect_chunks or any(
                    cnt != want.get(kn, 0) for kn, cnt in launches.items()):
                raise AssertionError(f"{name}: launches {launches} over "
                                     f"{chunks} chunks, eager counts {want}")
            if st.steady_compiles:
                raise AssertionError(f"{name}: steady captures "
                                     f"{st.compiles}")
            check_multi_price_caps(name, st, {"budgets": day.budgets,
                                              "scales": day.scales},
                                   src.chains)
            check_ledgers(name, day, src.chains)
            log(f"{name} day: windows {st.sizes}, wall {st.wall_s * 1e3:.3f}"
                f" ms, window ms (to the device's end) "
                f"{[round(x, 3) for x in st.submit_ms]}, stall ms "
                f"{[round(x, 3) for x in st.stall_ms]}; launches {launches} "
                f"over {chunks} chunks; captures {st.compiles}")
            for region, led in day.ledgers.items():
                rep = led.report()
                log(f"{name} ledger {region}: {rep['n_requests']} requests, "
                    f"{rep['flops']:.6e} FLOPs, {rep['kwh']:.6e} kWh, "
                    f"{rep['gco2e']:.6e} gCO2e (all-max "
                    f"{rep['baseline_gco2e']:.6e}), embodied "
                    f"{rep['embodied_gco2e']:.6e}, daily saved "
                    f"{rep['daily_saved_kwh']:.6e} kWh "
                    f"{rep['daily_saved_tco2e']:.6e} tCO2e")
            out[name] = {kn: launches[kn] for kn in WINDOW_KERNELS}
            days[name] = day
        log("carbon days: spends within their caps, ledgers == the served "
            "decisions exactly, gCO2e == kWh x CI, zero steady captures, "
            "launches == the eager counts, reports written")
        check_carbon_obs(stack, days["carbon"], report_dir)
        out.update(check_cli_carbon_day(report_dir))
    return out


def profile_served(label, src, pipe, t, n, **serve_kw):
    """One more full-width window (produce + serve), warm, through the
    graphs, under torch.profiler: its wall time, the device's busy time
    and idle share, and the host and device span of each phase range.
    Returns the profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk = src.window(t, n)
        res = pipe.serve_window(chunk.ctx, chunk.rows, tables=chunk.tables,
                                update_lam=False, ready=chunk.ready,
                                **serve_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if res.compiles:
        raise AssertionError(f"the profiled {label} was not warm")
    # device busy: the table's "Self CUDA time total" - kernels, copies
    # and sets, not the annotation ranges (streams overlap little here)
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
    log(f"profiled {label} (warm, graphs): wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms (idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f})")
    for k, v in order:
        log(f"  range {k}: host span {v['host']:.3f} ms, device span "
            f"{v['device']:.3f} ms")
    return prof


def profile_window(stack) -> None:
    """``profile_served`` on the serving window, then device time per
    kernel and the graphs' capture times and pools."""
    import torch

    prof = profile_served("window", stack.source, stack.pipeline, 1000,
                          stack.sizes[0])
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15), flush=True)
    graph_report(stack)
    log(f"device memory reserved {torch.cuda.memory_reserved() / 1e9:.3f} "
        f"GB, peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} "
        f"GB")


def profile_call(label: str, fn, rows: int = 8,
                 kernel: str | tuple[str, ...] | None = None,
                 warmup: bool = False):
    """``fn()`` once under torch.profiler: its wall time, the device's
    busy time and idle share, and the operators and kernels that took the
    most device time; with ``kernel`` (a name or several), the device time
    and busy share of the CUDA kernels whose name contains each, and of
    the rest.  With ``warmup``, one more call first, in the profiler's
    warm-up cycle, whose events are dropped (a step's profile without one
    has lost its first, longest kernel).  Returns fn's result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)
                 if warmup else None) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        # (leaving the context ends the active cycle; a step would clear it)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    log(f"profiled {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle share {max(0.0, 1 - busy_ms / wall_ms):.4f})")
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:rows]
    for e in top:
        log(f"  {e.key[:90]}: {e.self_device_time_total / 1e3:.3f} ms "
            f"device, {e.count} calls")
    if kernel is not None and busy_ms <= 0:
        log("  the profiler recorded no device time; no split")
    elif kernel is not None:
        rest_ms = busy_ms
        for name in (kernel,) if isinstance(kernel, str) else kernel:
            mine = [e for e in events if name in e.key
                    and e.device_type == DeviceType.CUDA]
            k_ms = sum(e.self_device_time_total for e in mine) / 1e3
            rest_ms -= k_ms
            log(f"  {name}: {k_ms:.3f} ms device in "
                f"{sum(e.count for e in mine)} calls, "
                f"{k_ms / busy_ms:.4f} of device busy")
        if not isinstance(kernel, str):
            log(f"  the rest: {rest_ms:.3f} ms device, "
                f"{rest_ms / busy_ms:.4f} of device busy")
    return out


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
            if arch == "dlrm-rm2" and shape == "serve_bulk":
                profile_call(f"{arch} x {shape}, one call (outside the "
                             f"count)", lambda: cell.fn(*args),
                             kernel="dot_interact_kernel")
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


# -- phase 6b: BST at full width ----------------------------------------------

BST_CALLS = {"serve_p99": 10, "serve_bulk": 2, "retrieval_cand": 1,
             "train_batch": 3}


def run_cell(label: str, cell, args, calls: int):
    """One warm call of ``cell.fn`` and ``calls`` timed ones (a train
    cell's calls are steps, each on the state the last returned), the
    launch counters reset before; raises if any kernel launched (the
    cells of BST and SchNet reach none).  Returns (args, last output,
    the timed calls' ms, the losses of every step, the peak GB)."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times, losses = [], []
    for i in range(1 + calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.fn(*args)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        if cell.kind == "train":
            state, loss = out
            args = (state, *args[1:])
            losses.append(float(loss))
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"{label}: launched {dict(ops.LAUNCHES)}; its "
                             f"path has no kernel")
    if losses and not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses {losses}")
    return (args, out, times, losses,
            torch.cuda.max_memory_allocated() / 1e9)


def cell_line(label, cell, setup_s, times, peak_gb) -> str:
    tflop = cell.meta["model_flops"] / 1e12
    return (f"{label}: set-up {setup_s:.2f} s; calls "
            f"{', '.join(f'{t:.3f}' for t in times)} ms; "
            f"{tflop / (min(times) * 1e-3):.3f} model TFLOP/s at the "
            f"fastest; peak memory {peak_gb:.2f} GB")


def serve_bst(seed: int) -> None:
    """BST's four cells at ``full_config()`` (4 M items, every batch at its
    published size), one warm call and ``BST_CALLS[shape]`` timed ones
    each, no kernel launched.  serve_p99's logits on the card against the
    port's CPU run of the same weights and batch (1e-5);
    retrieval_cand's first 512 candidates against ``forward`` on the
    user's row broadcast to them (1e-5); train_batch's losses finite."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L

    mod = configs.get_arch("bst")
    cfg = mod.full_config()
    model = mod.model
    for shape, calls in BST_CALLS.items():
        cell = mod.make_cell(shape, cfg=cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = cell.make_args(seed, "cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        label = f"bst x {shape}"
        args, out, times, losses, peak_gb = run_cell(label, cell, args,
                                                     calls)
        line = cell_line(label, cell, setup_s, times, peak_gb)
        if cell.kind == "train":
            log(f"{line}; losses {', '.join(f'{v:.6f}' for v in losses)}")
        else:
            n = (args[2].shape[0] if cell.kind == "retrieval"
                 else args[1]["item_id"].shape[0])
            if out.shape != (n,) or not torch.isfinite(out).all():
                raise AssertionError(f"{label}: logits {tuple(out.shape)} "
                                     f"not finite (n={n})")
            log(f"{line}; logits sum {float(out.double().sum()):.6f}")
        if shape == "serve_p99":
            with torch.no_grad():
                want = model.forward(L.to_device(args[0], "cpu"), cfg,
                                     L.to_device(args[1], "cpu"))
            err = close(out, want.cuda(), 1e-5)
            log(f"bst serve_p99 card vs cpu (same weights and batch): max "
                f"abs err {err:.3e} (tol 1e-5)")
        if cell.kind == "retrieval":
            params, user, cid, ccat = args
            c = 512
            with torch.no_grad():
                full = {k: v.expand(c, v.shape[1]) for k, v in user.items()}
                full.update(item_id=cid[:c], item_cat=ccat[:c])
                err = close(out[:c], model.forward(params, cfg, full), 1e-5)
            log(f"bst retrieval == forward on the broadcast batch (first "
                f"{c} candidates): max abs err {err:.3e}")
        del args, out, cell
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 6c: SchNet's four train cells ---------------------------------------

SCHNET_STEPS = {"molecule": 5, "full_graph_sm": 5, "minibatch_lg": 5,
                "ogb_products": 2}
SCHNET_CHUNK = 1000  # edges a chunk in the chunked-vs-unchunked check


def schnet_grads(model, cfg, params, batch, **kw):
    from repro_torch.training.trainer import value_and_grad
    return value_and_grad(lambda p, b: model.loss_fn(p, cfg, b, **kw),
                          params, batch)


def check_schnet_chunks(label, model, cfg, params, batch) -> None:
    """The chunked path, forced by SCHNET_CHUNK-edge chunks, against the
    unchunked one on the card: the loss within 1e-5 and every gradient
    within 5e-5 of its largest magnitude (both sum the messages by
    atomics, in other orders); then the finding: two identical unchunked
    gradient evaluations, bit for bit equal or not."""
    import torch
    from repro_torch.tree import leaves

    loss, grads = schnet_grads(model, cfg, params, batch)
    c_loss, c_grads = schnet_grads(model, cfg, params, batch,
                                   edge_chunk=SCHNET_CHUNK)
    err = close(c_loss, loss, 1e-5)
    g_err = max(float((got - want).abs().max())
                / max(float(want.abs().max()), 1e-30)
                for got, want in zip(leaves(c_grads), leaves(grads)))
    if not g_err <= 5e-5:
        raise AssertionError(f"{label}: chunked gradients differ by {g_err} "
                             f"of their largest magnitude")
    n_chunks = -(-batch["src"].shape[0] // SCHNET_CHUNK)
    r_loss, r_grads = schnet_grads(model, cfg, params, batch)
    same = bool(torch.equal(r_loss, loss)) and all(
        torch.equal(a, b) for a, b in zip(leaves(r_grads), leaves(grads)))
    log(f"{label} chunked ({n_chunks} chunks of {SCHNET_CHUNK} edges, "
        f"recomputed) vs unchunked on the card: loss max abs err "
        f"{err:.3e} (tol 1e-5), gradients {g_err:.3e} of their largest "
        f"magnitude (tol 5e-5); two identical gradient evaluations "
        f"bitwise equal: {same} (index_add sums by atomics)")


def train_schnet(seed: int) -> None:
    """SchNet's four train cells at ``full_config(shape)`` and the JAX
    sizes, nothing cut: one warm step and ``SCHNET_STEPS[shape]`` timed
    ones each, no kernel launched, finite losses; ms a step, model
    TFLOP/s, peak memory.  minibatch_lg's set-up includes sampling the
    1,024-seed subgraph on the host; ogb_products (61.9 M edges) runs in
    15 edge chunks with recompute.  At molecule and full_graph_sm,
    ``check_schnet_chunks``."""
    import gc

    import torch
    from repro_torch import configs

    mod = configs.get_arch("schnet")
    for shape, steps in SCHNET_STEPS.items():
        cell = mod.make_cell(shape)
        cfg = mod.full_config(shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = cell.make_args(seed, "cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        label = (f"schnet x {shape} (N={cell.meta['n_nodes']}, "
                 f"E={cell.meta['n_edges']})")
        params0 = args[0].params
        args, _, times, losses, peak_gb = run_cell(label, cell, args, steps)
        log(f"{cell_line(label, cell, setup_s, times, peak_gb)}; losses "
            f"{', '.join(f'{v:.6f}' for v in losses)}")
        if shape in ("molecule", "full_graph_sm"):
            check_schnet_chunks(f"schnet x {shape}", mod.model, cfg,
                                params0, args[1])
        del args, params0, cell
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 8: gemma2-2b at full width ---------------------------------------

LM_SERVE_T, LM_SERVE_MAX, LM_DECODE_STEPS = 32760, 32768, 8
LM_STEP_TOL = 2e-3  # f32 decode step vs f32 prefill(T + 1)
BF16_FLASH, F32_FLASH = "flash_attention_wgmma", "flash_attention"


def lm_launch_check(what: str, got: dict, bf16: int, f32: int = 0) -> None:
    """The counts since the last reset: ``bf16`` launches of the wgmma
    kernel, ``f32`` of the f32 (3xTF32) one and none of any other."""
    want = {k: 0 for k in got}
    want[BF16_FLASH], want[F32_FLASH] = bf16, f32
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def serve_lm(seed: int) -> tuple[int, int]:
    """gemma2-2b at full_config(): prefill B = 1, T = 32,760 into a
    32,768-position cache in bf16, then 8 greedy decode steps, timed.
    Its launches: 26 of the wgmma kernel in the prefill, none in the
    steps.

    Then, counted apart, the first step is checked against the
    last-token logits of a prefill of those T + 1 tokens.  It is held in
    f32 (the same weights, not cast) within LM_STEP_TOL, where the two
    paths differ only in f32 summation order (the flash kernel against
    the plain attention of decode, cuBLAS at M = 32,761 against M = 1,
    through 26 layers).  In bf16 the gap is printed beside two witnesses
    of bf16 rounding at this width, bf16 against f32 prefill(T + 1) and
    the bf16 against the f32 step, and is held to be no larger than the
    first: the two bf16 paths may differ only by bf16 rounding.  The
    identity check launches the wgmma kernel 26 times (the bf16
    prefill(T + 1)) and the f32 kernel 52 times (the two f32 prefills,
    whose wall times it prints).  Returns the wgmma kernel's launches on
    the served path and the f32 kernel's in the f32 prefills."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = gemma2_2b.full_config()
    params32 = lm.init(torch.Generator().manual_seed(seed), cfg, "cuda")
    params = lm.cast_params(params32, cfg.compute_dtype)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, LM_SERVE_T))).cuda()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, toks, max_len=LM_SERVE_MAX)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    lm_launch_check("prefill", dict(ops.LAUNCHES), bf16=cfg.n_layers)
    nxt = logits.argmax(-1)
    first, steps = None, []
    for i in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, cache = lm.decode_step(params, cfg, nxt, cache)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(step).all():
            raise AssertionError(f"decode step {i}: logits not finite")
        if first is None:
            first, first_tok = step, nxt
        nxt = step.argmax(-1)
    lm_launch_check("decode", dict(ops.LAUNCHES), bf16=cfg.n_layers)
    path_launches = ops.LAUNCHES[BF16_FLASH]
    if cache["length"] != LM_SERVE_T + LM_DECODE_STEPS:
        raise AssertionError(f"cache length {cache['length']}")
    log(f"gemma2-2b serve path (B=1, bf16): prefill T={LM_SERVE_T} "
        f"{prefill_ms:.1f} ms; {LM_DECODE_STEPS} greedy steps "
        f"{', '.join(f'{t:.2f}' for t in steps)} ms")
    del cache
    torch.cuda.empty_cache()

    # the identity checks: not the served path, kept out of its count
    ops.reset_launches()
    longer = torch.cat([toks, first_tok[:, None]], 1)
    want16, _ = profile_call(
        f"gemma2-2b bf16 prefill of {LM_SERVE_T + 1} tokens (B=1)",
        lambda: lm.prefill(params, cfg, longer, max_len=LM_SERVE_MAX),
        kernel="flash_wgmma_kernel")
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def timed_prefill(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.prefill(params32, cfg32, x, max_len=LM_SERVE_MAX)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (_, cache), ms_t = timed_prefill(toks)
    got, cache = lm.decode_step(params32, cfg32, first_tok, cache)
    del cache
    torch.cuda.empty_cache()
    (want, _), ms_t1 = timed_prefill(longer)
    log(f"gemma2-2b f32 identity prefills (B=1): T={LM_SERVE_T} "
        f"{ms_t:.1f} ms, T={LM_SERVE_T + 1} {ms_t1:.1f} ms")
    lm_launch_check("identity checks", dict(ops.LAUNCHES),
                    bf16=cfg.n_layers, f32=2 * cfg.n_layers)
    f32_launches = ops.LAUNCHES[F32_FLASH]
    err = close(got, want, LM_STEP_TOL)

    def gap(a, b):
        return float((a.float() - b.float()).abs().max())

    log(f"gemma2-2b step 1 vs prefill(T+1) in f32: max abs err {err:.4e} "
        f"(tol {LM_STEP_TOL}, logits max abs {float(want.abs().max()):.3f})")
    bf16_gap, rounding = gap(first, want16), gap(want16, want)
    log(f"gemma2-2b step 1 vs prefill(T+1) in bf16: max abs diff "
        f"{bf16_gap:.4e}; bf16 rounding at this width: prefill(T+1) bf16 "
        f"vs f32 {rounding:.4e}, step 1 bf16 vs f32 {gap(first, got):.4e} "
        f"(logits max abs {float(want16.float().abs().max()):.3f})")
    if not bf16_gap <= rounding:
        raise AssertionError(f"bf16 step 1 differs from bf16 prefill(T+1) "
                             f"by {bf16_gap}, more than bf16 prefill(T+1) "
                             f"differs from f32 ({rounding})")
    return path_launches, f32_launches


LM_CALLS = {"prefill_32k": 1, "decode_32k": 8}


def serve_lm_cells(seed: int, arch: str = "gemma2-2b",
                   calls_of: dict = LM_CALLS) -> int:
    """An LM's prefill_32k and decode_32k cells at the config module's cut
    batches (gemma2-2b: B = 4 and 8; a cache of 32,768 positions at
    length 32,767 in decode) through ``configs.get_arch(...).make_cell(
    ...)``: one warm call and ``calls_of[shape]`` timed calls, launch
    counts reset before and read after each cell (the wgmma kernel once a
    layer in each prefill forward, never in decode).  Returns the cells'
    wgmma kernel launches (all of them bf16)."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops

    from repro_torch.models import lm

    mod = configs.get_arch(arch)
    cfg = mod.full_config()
    launched = 0
    for shape, calls in calls_of.items():
        cell = mod.make_cell(shape, cfg=cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = cell.make_args(seed, "cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        lm.HOST_READS["moe_counts"] = 0
        out = cell.fn(*args)  # warm call
        times = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        got = dict(ops.LAUNCHES)
        per_call = cfg.n_layers if cell.kind == "prefill" else 0
        lm_launch_check(f"{arch} x {shape}", got,
                        bf16=(1 + calls) * per_call)
        reads = lm.HOST_READS["moe_counts"]
        if reads != (1 + calls) * (cfg.n_layers if cfg.moe else 0):
            raise AssertionError(f"{arch} x {shape}: {reads} host reads "
                                 f"of the routing counts in {1 + calls} "
                                 f"calls")
        routing = (f"; host reads of the routing counts "
                   f"{reads // (1 + calls)} a call" if cfg.moe else "")
        if cell.kind == "decode":
            profile_call(f"{arch} x {shape}, one step",
                         lambda: cell.fn(*args))
        launched += got[BF16_FLASH]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        b = cell.meta["batch"]
        if out.shape != (b, cfg.padded_vocab) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"{arch} x {shape}: logits "
                                 f"{tuple(out.shape)} not finite")
        tflop = cell.meta["model_flops"] / 1e12
        log(f"{arch} x {shape} (B={b}, S={cell.meta['seq']}): set-up "
            f"{setup_s:.2f} s; calls {', '.join(f'{t:.3f}' for t in times)}"
            f" ms; {tflop / (min(times) * 1e-3):.2f} model TFLOP/s at the "
            f"fastest; peak memory {peak_gb:.2f} GB; launches "
            f"{got[BF16_FLASH]} {BF16_FLASH} ({per_call} a forward)"
            f"{routing}; logits sum {float(out.double().sum()):.6f}")
        del args, out, cell
        gc.collect()
        torch.cuda.empty_cache()
    return launched


def lm_parity(seed: int) -> None:
    """gemma2-2b smoke_config (f32) from one seed on the CPU and, the same
    weights moved, on the card: forward logits, prefill logits and cache
    and two decode steps within 1e-5."""
    import numpy as np
    import torch
    from repro_torch.configs import gemma2_2b
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    cfg = gemma2_2b.smoke_config()
    params = lm.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    on_card = L.to_device(params, "cuda")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 24)))
    err = close(lm.forward(on_card, cfg, toks.cuda()),
                lm.forward(params, cfg, toks).cuda(), 1e-5)
    want, c_cpu = lm.prefill(params, cfg, toks, max_len=32)
    got, c_card = lm.prefill(on_card, cfg, toks.cuda(), max_len=32)
    err = max(err, close(got, want.cuda(), 1e-5),
              close(c_card["k"], c_cpu["k"].cuda(), 1e-5))
    for _ in range(2):
        nxt = want.argmax(-1)
        want, c_cpu = lm.decode_step(params, cfg, nxt, c_cpu)
        got, c_card = lm.decode_step(on_card, cfg, nxt.cuda(), c_card)
        err = max(err, close(got, want.cuda(), 1e-5))
    log(f"gemma2-2b smoke_config card vs cpu (forward, prefill, cache, 2 "
        f"decode steps): max abs err {err:.3e} (tol 1e-5)")


# -- phase 8b: glm4-9b and minicpm-2b at full width ---------------------------

DENSE_LMS = ("glm4-9b", "minicpm-2b")
DENSE_CALLS = {"prefill_32k": 1, "decode_32k": 4}
DENSE_HEADS_T = 8192  # the bf16 kernel timed at each arch's head layout
DENSE_HEADS_CELL = (4, 32768)  # and held at the prefill cell's (B, T)
F32_REF_BLOCK = 512  # query rows a block of the f32 reference
# the bf16 kernel against the f32 reference: ||err|| / ||want|| over the
# whole output, and the same over each (b, t, h) row of dh, the worst row.
# Set from the readings at both archs' heads and both shapes on an H100:
# the kernel rel 2.07e-3 to 2.11e-3 and rows up to 3.90e-3, SDPA the
# same to 1e-5, the plain version (bf16 logits) 3.86e-3 and 1.80e-2;
# each run logs all three beside the limits
FLASH_F32_REL_TOL, FLASH_F32_ROW_TOL = 3e-3, 6e-3
# the f32 step(T) = prefill(T + 1) of 8b, at half gemma2's 32,760: at
# 32,760 glm4-9b's two f32 prefills took 40.8 s and minicpm-2b's 19.2
IDENTITY_T, IDENTITY_MAX = 16376, 16384


def flash_f32_distance(outs: dict, q, k, v) -> dict:
    """Each output in ``outs`` (name -> (B, T, H, dh), T = S) against
    causal attention computed from q, k and v upcast to f32 (f32 logits,
    f32 softmax, f32 products; TF32 is off), F32_REF_BLOCK query rows at
    a time against the keys they admit, so it reaches T = 32,768.  Returns
    {name: {"rel": ||out - want|| / ||want||, "row": the largest over the
    (b, t, h) rows of dh of the same ratio, "max_abs": ...}}."""
    import torch

    b, t, h, dh = q.shape
    hk = k.shape[2]
    acc = {n: {"err2": 0.0, "row": 0.0, "max_abs": 0.0} for n in outs}
    want2 = 0.0
    for bi in range(b):
        kf, vf = k[bi].float(), v[bi].float()
        for t0 in range(0, t, F32_REF_BLOCK):
            t1 = min(t, t0 + F32_REF_BLOCK)
            qf = q[bi, t0:t1].float().reshape(t1 - t0, hk, h // hk, dh)
            logits = torch.einsum("tkgd,skd->kgts", qf, kf[:t1])
            logits *= 1.0 / math.sqrt(dh)
            pos = torch.arange(t1, device=q.device)
            logits.masked_fill_(pos[None, :] > pos[t0:t1, None],
                                float("-inf"))
            want = torch.einsum("kgts,skd->tkgd", logits.softmax(-1),
                                vf[:t1]).reshape(t1 - t0, h, dh)
            del logits
            want2 += float(want.double().square().sum())
            norm = want.norm(dim=-1)
            for n, out in outs.items():
                d = out[bi, t0:t1].float() - want
                a = acc[n]
                a["err2"] += float(d.double().square().sum())
                a["max_abs"] = max(a["max_abs"], float(d.abs().max()))
                a["row"] = max(a["row"],
                               float((d.norm(dim=-1) / norm).max()))
    return {n: {"rel": math.sqrt(a["err2"] / want2), "row": a["row"],
                "max_abs": a["max_abs"]} for n, a in acc.items()}


def check_flash_f32(label: str, dist: dict) -> dict:
    """Logs each output's distance from the f32 reference (the kernel's
    beside the plain version's and SDPA's, which calibrate the limits)
    and raises unless the kernel's is within FLASH_F32_REL_TOL and
    FLASH_F32_ROW_TOL."""
    log(f"{label} vs f32 reference: " + "; ".join(
        f"{n} rel {d['rel']:.3e} row {d['row']:.3e} max abs "
        f"{d['max_abs']:.3e}" for n, d in dist.items())
        + f" (kernel tol rel {FLASH_F32_REL_TOL}, row {FLASH_F32_ROW_TOL})")
    got = dist["kernel"]
    if not (got["rel"] <= FLASH_F32_REL_TOL
            and got["row"] <= FLASH_F32_ROW_TOL):
        raise AssertionError(f"{label}: the kernel is {got} from the f32 "
                             f"reference")
    return got


def check_flash_heads(arch: str) -> dict:
    """The bf16 (wgmma) kernel at the head layout of ``arch``'s prefill
    (glm4-9b: 32 query heads on 2 kv heads, dh = 128; minicpm-2b: 36
    heads, no grouping, dh = 64), causal, no softcap.  At B = 1, T = S =
    8,192: against its plain version (2e-2; its logits are rounded to
    bf16 as JAX's are), timed beside it and beside
    ``F.scaled_dot_product_attention`` (causal, GQA), with its bound.  At
    that shape and at the prefill cell's B = 4, T = S = 32,768: against
    the f32 reference (``flash_f32_distance``, ``check_flash_f32``).
    These calls stay out of the path's count."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import ops, ref

    cfg = configs.get_arch(arch).full_config()
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(17)

    def draw(b, t):
        return tuple(torch.randn(b, t, n, dh, generator=gen, device="cuda")
                     .to(torch.bfloat16) for n in (h, hk, hk))

    def sdpa(q, k, v):
        qt, kt, vt = (y.transpose(1, 2) for y in (q, k, v))
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)

    t = DENSE_HEADS_T
    q, k, v = draw(1, t)
    if ops.flash_kernel(q, k, v) != BF16_FLASH:
        raise AssertionError(f"{arch}'s heads do not route to {BF16_FLASH}")
    got = ops.flash_attention(q, k, v)
    plain = ref.flash_attention_ref(q, k, v)
    err = close(got.float(), plain.float(), 2e-2)
    shape = f"B=1 T=S={t} H={h} Hkv={hk} dh={dh} causal bf16"
    f32 = check_flash_f32(f"{BF16_FLASH} at {arch}'s heads [{shape}]",
                          flash_f32_distance({"kernel": got, "plain": plain,
                                              "sdpa": sdpa(q, k, v)},
                                             q, k, v))
    del plain
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v), reps=10, warm=1)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), reps=2,
                       warm=1)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v), reps=10, warm=2)
    lib_diff = float((got.float() - sdpa(q, k, v).float()).abs().max())
    b_ms, by = flash_bound(1, t, t, h, hk, dh, 2, -1)
    cb, ct = DENSE_HEADS_CELL
    del q, k, v, got
    q, k, v = draw(cb, ct)
    cell_shape = f"B={cb} T=S={ct} H={h} Hkv={hk} dh={dh} causal bf16"
    got = ops.flash_attention(q, k, v)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{arch} [{cell_shape}]: not finite")
    f32_cell = check_flash_f32(
        f"{BF16_FLASH} at {arch}'s heads [{cell_shape}]",
        flash_f32_distance({"kernel": got, "sdpa": sdpa(q, k, v)}, q, k, v))
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
           "library_max_abs_diff": lib_diff, "shape": shape, "f32_ref": f32,
           "f32_ref_cell": {"shape": cell_shape, **f32_cell}}
    log(f"{BF16_FLASH} at {arch}'s heads [{shape}]: max abs err {err:.3e} "
        f"vs plain (tol 2e-2), {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {by} ({b_ms / ms:.4f} of it), SDPA "
        f"{lib_ms:.4f} ms (max abs diff {lib_diff:.3e})")
    return row


def dense_identity(seed: int, arch: str) -> int:
    """``arch`` at full width in f32 (the weights as ``init`` draws them,
    not cast): a decode step after the prefill of T = 16,376 tokens
    against the last-token logits of the prefill of those T + 1 tokens,
    within LM_STEP_TOL (f32 summation order only: the f32 flash kernel
    against decode's plain attention, cuBLAS at M = T + 1 against M = 1).
    glm4-9b's f32 weights are 37.6 GB and its f32 cache 1.3 GB at B = 1,
    so no depth is cut.  Returns the f32 kernel's launches (two
    prefills)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = configs.get_arch(arch).full_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = lm.init(torch.Generator().manual_seed(seed), cfg32, "cuda")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, IDENTITY_T + 1))).cuda()
    ops.reset_launches()
    times = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    _, cache = timed(lambda: lm.prefill(params, cfg32, toks[:, :-1],
                                        max_len=IDENTITY_MAX))
    got, cache = lm.decode_step(params, cfg32, toks[:, -1], cache)
    del cache
    torch.cuda.empty_cache()
    want, _ = timed(lambda: lm.prefill(params, cfg32, toks,
                                       max_len=IDENTITY_MAX))
    lm_launch_check(f"{arch} identity check", dict(ops.LAUNCHES), bf16=0,
                    f32=2 * cfg.n_layers)
    err = close(got, want, LM_STEP_TOL)
    log(f"{arch} f32 step 1 vs prefill(T+1) at T={IDENTITY_T} (B=1, all "
        f"{cfg.n_layers} layers): max abs err {err:.4e} (tol {LM_STEP_TOL}, "
        f"logits max abs {float(want.abs().max()):.3f}); prefills "
        f"{times[0]:.1f} and {times[1]:.1f} ms")
    return ops.LAUNCHES[F32_FLASH]


def serve_dense_lms(seed: int) -> dict:
    """Phase 8b: for glm4-9b and minicpm-2b, the bf16 kernel at the arch's
    head layout (``check_flash_heads``), the prefill_32k and decode_32k
    cells at the config modules' cut batches (``serve_lm_cells``), and the
    f32 identity (``dense_identity``).  Returns the cells' wgmma launches,
    the identity checks' f32 launches and the head-layout rows."""
    import gc

    import torch

    out = {"bf16": 0, "f32": 0, "heads": {}}
    for arch in DENSE_LMS:
        out["heads"][arch] = check_flash_heads(arch)
        gc.collect()
        torch.cuda.empty_cache()
        out["bf16"] += serve_lm_cells(seed, arch, DENSE_CALLS)
        gc.collect()
        torch.cuda.empty_cache()
        out["f32"] += dense_identity(seed, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 8c: the MoE LMs at full width -------------------------------------

MOE_LMS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
MOE_CALLS = {"prefill_32k": 1, "decode_32k": 2}
MOE_LAYER_SHAPE = (2, 2048)  # (B, T): the one-layer check's 4,096 tokens
MOE_BF16_TOL = 2e-2  # grouped vs plain in bf16, of the largest magnitude
MOE_F32_TOL = 1e-5  # grouped vs plain in f32, of the largest magnitude
# the bf16 grouped layer against the plain one in f32 on the same bf16
# inputs: ||err|| / ||want|| over the tokens that route to the same k
# experts in bf16 and in f32 (a bf16 router logit can reorder two close
# probabilities: such tokens are counted and logged, not held)
MOE_F32_REL_TOL = 1e-2
MOE_GRAD_NAMES = ("x", "router", "w1", "w2", "w3")


def moe_fwd_bwd(fn, cfg, p, x, cot):
    """fn(p, cfg, x) -> (out, aux) on copies of p's leaves and x that
    require grad, then the gradient of sum(out * cot) + aux: (out, aux,
    [dx, d router, d w1, d w2, d w3])."""
    import torch

    leaf = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    xg = x.detach().clone().requires_grad_(True)
    out, aux = fn(leaf, cfg, xg)
    ((out.float() * cot).sum() + aux).backward()
    grads = [xg.grad] + [leaf[k].grad for k in MOE_GRAD_NAMES[1:]]
    return out.detach(), aux.detach(), grads


def moe_route_sets(p, cfg, xt):
    """Each token's k experts, sorted: (n, k)."""
    from repro_torch.models import lm
    return lm._route(p, cfg, xt)[2].sort(-1).values


def check_moe_layer(arch: str, seed: int) -> None:
    """One MoE layer of ``arch`` at the full widths (its router and
    expert leaves as ``lm.init`` draws them) on MOE_LAYER_SHAPE's 4,096
    tokens from a seed.  In bf16 (the weights cast once) and in f32, the
    grouped path (``lm._moe_grouped``) against the plain one
    (``lm._moe_ref``), forward (MOE_BF16_TOL, MOE_F32_TOL of the largest
    magnitude) and every gradient of sum(out * cot) + aux (``close_rel``:
    2e-2 and 5e-5 of each one's largest magnitude); the bf16 grouped
    output against the f32 plain one on the same bf16 inputs
    (MOE_F32_REL_TOL over the tokens routed alike, the plain bf16
    output's distance logged beside it); a second run of the bf16
    forward and backward bit for bit the first; each token's k rows
    dispatched (0 tokens reaching no expert).  Times the grouped and the
    plain bf16 forward on the 4,096 tokens and on a decode_32k step's
    (the cell's batch, a token a sequence).  Outside the path's count
    (no flash kernel runs)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_arch(arch).full_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    one = dataclasses.replace(cfg, n_layers=1)
    full = lm._layer(lm.init(torch.Generator().manual_seed(seed), one,
                             "cuda"), 0)
    p32 = {k: full[k] for k in MOE_GRAD_NAMES[1:]}
    del full
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    b, t = MOE_LAYER_SHAPE
    n, k, d = b * t, cfg.moe.top_k, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(b, t, d, generator=gen, device="cuda")
    cot = torch.randn(b, t, d, generator=gen, device="cuda")
    x16 = x.to(torch.bfloat16)
    shape = (f"B={b} T={t} d={d} E={cfg.moe.n_experts} k={k} "
             f"f={cfg.moe.d_expert}")

    # dispatch: every token's k rows reach an expert
    _, _, top_e = lm._route(p16, cfg, x16.reshape(n, d))
    order, _, counts = lm._dispatch(top_e, cfg.moe.n_experts)
    per_token = torch.bincount(order // k, minlength=n)
    dropped = int((per_token == 0).sum())
    if dropped or not bool((per_token == k).all()) \
            or int(counts.sum()) != n * k:
        raise AssertionError(f"{arch} MoE layer: {dropped} tokens reached "
                             f"no expert; rows a token "
                             f"{per_token.unique().tolist()}")
    idle = int((counts == 0).sum())

    out = {}
    for name, cf, p, xi in (("bf16", cfg, p16, x16),
                            ("f32", cfg32, p32, x)):
        got = moe_fwd_bwd(lm._moe_grouped, cf, p, xi, cot)
        want = moe_fwd_bwd(lm._moe_ref, cf, p, xi, cot)
        tol = MOE_BF16_TOL if name == "bf16" else MOE_F32_TOL
        scale = float(want[0].float().abs().max())
        err = float((got[0].float() - want[0].float()).abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"{arch} MoE layer {name}: grouped vs "
                                 f"plain max abs err {err:.3e}, tol "
                                 f"{tol} x {scale:.3e}")
        aux_err = abs(float(got[1]) - float(want[1]))
        rel, abs_err = close_rel(got[2], want[2],
                                 f"{arch} MoE layer {name} gradients")
        out[name] = {"max_abs_err": err, "scale": scale, "aux": float(got[1]),
                     "aux_err": aux_err, "grad_rel": rel,
                     "grad_abs": abs_err}
        if name == "bf16":
            first = got
            repeat_bitwise(
                lambda: (lambda r: (r[0], r[1], *r[2]))(
                    moe_fwd_bwd(lm._moe_grouped, cf, p, xi, cot)),
                (got[0], got[1], *got[2]),
                f"{arch} MoE layer bf16 forward and backward")
            plain16 = want[0]
        del got, want
    # the bf16 grouped output against the f32 plain one on the same
    # bf16 inputs, over the tokens routed alike
    p16_32 = {kk: v.float() for kk, v in p16.items()}
    with torch.no_grad():
        ref32, _ = lm._moe_ref(p16_32, cfg32, x16.float())
        same = (moe_route_sets(p16, cfg, x16.reshape(n, d))
                == moe_route_sets(p16_32, cfg32,
                                  x16.float().reshape(n, d))).all(-1)
    flipped = int((~same).sum())
    want32 = ref32.reshape(n, d)[same]

    def rel_to_f32(y):
        y = y.float().reshape(n, d)
        diff_all = float((y - ref32.reshape(n, d)).norm()
                         / ref32.norm())
        return float((y[same] - want32).norm() / want32.norm()), diff_all

    rel, rel_all = rel_to_f32(first[0])
    plain_rel, plain_all = rel_to_f32(plain16)
    if not rel <= MOE_F32_REL_TOL:
        raise AssertionError(f"{arch} MoE layer: bf16 grouped vs f32 plain "
                             f"rel {rel:.3e} over tokens routed alike "
                             f"(tol {MOE_F32_REL_TOL})")
    grouped_ms = cuda_ms(lambda: lm._moe_grouped(p16, cfg, x16), reps=5,
                         warm=1)
    plain_ms = cuda_ms(lambda: lm._moe_ref(p16, cfg, x16), reps=3, warm=1)
    # at a decode step's tokens (one a sequence of the cell's batch)
    nd = configs.get_arch(arch).CELL_BATCH["decode_32k"]
    xd = x16.reshape(n, d)[:nd].reshape(nd, 1, d)
    dec_grouped_ms = cuda_ms(lambda: lm._moe_grouped(p16, cfg, xd),
                             reps=20, warm=2)
    dec_plain_ms = cuda_ms(lambda: lm._moe_ref(p16, cfg, xd), reps=20,
                           warm=2)
    dec_idle = int((lm._dispatch(lm._route(p16, cfg, xd.reshape(nd, d))[2],
                                 cfg.moe.n_experts)[2] == 0).sum())
    b16, f32 = out["bf16"], out["f32"]
    log(f"{arch} MoE layer [{shape}]: grouped vs plain, bf16 max abs err "
        f"{b16['max_abs_err']:.3e} (tol {MOE_BF16_TOL} x {b16['scale']:.3e})"
        f", aux {b16['aux']:.6f} (diff {b16['aux_err']:.1e}), gradients "
        f"{b16['grad_rel']:.3e} of their largest; f32 max abs err "
        f"{f32['max_abs_err']:.3e} (tol {MOE_F32_TOL} x {f32['scale']:.3e}),"
        f" aux diff {f32['aux_err']:.1e}, gradients {f32['grad_rel']:.3e}; "
        f"bf16 forward and backward bitwise repeatable; 0 of {n} tokens "
        f"dropped ({k} rows each), {idle} of {cfg.moe.n_experts} experts "
        f"without a row")
    log(f"{arch} MoE layer bf16 vs f32 plain on the same bf16 inputs: "
        f"grouped rel {rel:.3e} (tol {MOE_F32_REL_TOL}), plain bf16 rel "
        f"{plain_rel:.3e}, over the {n - flipped} tokens routed alike; "
        f"{flipped} tokens route otherwise in f32 (all tokens: grouped rel "
        f"{rel_all:.3e}, plain {plain_all:.3e}); bf16 forward ms: grouped "
        f"{grouped_ms:.3f}, plain {plain_ms:.3f}; at decode_32k's {nd} "
        f"tokens ({dec_idle} of {cfg.moe.n_experts} experts without a row)"
        f": grouped {dec_grouped_ms:.3f}, plain {dec_plain_ms:.3f}")


def moe_identity(seed: int, arch: str) -> int:
    """``dense_identity`` at ``arch`` (the f32 step(T) = prefill(T + 1)
    within LM_STEP_TOL) with each layer's routing of the last token
    recorded: the decode step's and prefill(T + 1)'s last row, the margin
    between the k-th and (k+1)-th probability, and whether both chose
    the same k experts.  Returns the f32 kernel's launches."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_arch(arch).full_config()
    k, seen = cfg.moe.top_k, []
    route = lm._route

    def recorded(p, c, xt):
        probs, top_w, top_e = route(p, c, xt)
        top = probs[-1].topk(k + 1).values
        seen.append((float(top[k - 1] - top[k]),
                     sorted(top_e[-1].tolist())))
        return probs, top_w, top_e

    lm._route = recorded
    try:
        launched = dense_identity(seed, arch)
    finally:
        lm._route = route
    n = cfg.n_layers
    step, longer = seen[n:2 * n], seen[2 * n:3 * n]
    same = [a[1] == b[1] for a, b in zip(step, longer)]
    log(f"{arch} identity routing of the last token, layer by layer: "
        f"margin (k-th - (k+1)-th prob) in the step "
        f"{', '.join(f'{m:.3e}' for m, _ in step)}; the same {k} experts "
        f"as prefill(T+1) in {sum(same)} of {n} layers")
    if not all(same):
        raise AssertionError(f"{arch}: the step and prefill(T+1) route the "
                             f"last token otherwise in layers "
                             f"{[i for i, s in enumerate(same) if not s]}")
    return launched


def serve_moe_lms(seed: int) -> dict:
    """Phase 8c: for granite-moe-1b-a400m and olmoe-1b-7b, the bf16 flash
    kernel at the arch's head layout (``check_flash_heads``), one MoE
    layer at the full widths (``check_moe_layer``), the prefill_32k and
    decode_32k cells at the config modules' cut batches
    (``serve_lm_cells``, with the routing counts' host reads), and the
    f32 identity (``moe_identity``).  Returns the cells' wgmma launches,
    the identity checks' f32 launches and the head-layout rows."""
    import gc

    import torch

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"bf16": 0, "f32": 0, "heads": {}}
    for arch in MOE_LMS:
        t0 = time.perf_counter()
        out["heads"][arch] = check_flash_heads(arch)
        release()
        check_moe_layer(arch, seed)
        release()
        out["bf16"] += serve_lm_cells(seed, arch, MOE_CALLS)
        release()
        out["f32"] += moe_identity(seed, arch)
        release()
        log(f"phase 8c {arch}: {time.perf_counter() - t0:.1f}s")
    return out


# -- phase 9: training on the card ------------------------------------------

TRAIN_STEPS = 5  # timed DIN train_batch steps, after one warm step
EXP_CFG = dict(world=dict(n_users=800, n_items=200, hist_len=10, seed=3),
               expose=8, n_scales=4, cascade_steps=120, reward_steps=300,
               batch=48)  # tests/conftest.py's system_exp
TRAINED_WINDOWS, TRAINED_REQUESTS = 4, 512


def train_din_full(seed: int) -> dict:
    """Phase 9a: DIN's train_batch cell at ``full_config()`` (10 M items,
    100 k categories, 1 M user rows, embed 18, T = 100, attention 80-40,
    MLP 200-80, B = 65,536): one warm step and ``TRAIN_STEPS`` timed
    ones, the counters reset before and read after (one
    ``target_attention`` and one ``target_attention_bwd`` a step, nothing
    else); finite losses; then, outside the count, every leaf's gradient
    at the trained state, finite and from the graph (none unused), the
    attention MLP's nonzero."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import din
    from repro_torch.tree import leaves_with_paths, unflatten

    mod = configs.get_arch("din")
    cfg = mod.full_config()
    cell = mod.make_cell("train_batch", cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, batch = cell.make_args(seed, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, loss = cell.fn(state, batch)  # warm step
    losses, times = [float(loss)], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = cell.fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    got = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = 1 + TRAIN_STEPS
    want = {k: 0 for k in got}
    want["target_attention"] = want["target_attention_bwd"] = steps
    if got != want:
        raise AssertionError(f"din train_batch: launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"din train_batch: losses {losses}")
    profile_call("din x train_batch, one step (outside the count)",
                 lambda: cell.fn(state, batch), rows=12,
                 kernel=("target_attention_kernel", "target_attention_bwd"),
                 warmup=True)
    paths, flat = zip(*leaves_with_paths(state.params))
    req = [p.detach().requires_grad_(True) for p in flat]
    tree = unflatten(state.params, req)
    grads = torch.autograd.grad(din.loss_fn(tree, cfg, batch), req)
    for path, g in zip(paths, grads):
        if not torch.isfinite(g).all():
            raise AssertionError(f"din train_batch: gradient of {path} is "
                                 f"not finite")
        if path.startswith("attn/") and not float(g.abs().max()) > 0:
            raise AssertionError(f"din train_batch: gradient of {path} is 0")
    gflop = cell.meta["model_flops"] / 1e9
    log(f"din x train_batch (B=65536, full_config): set-up {setup_s:.2f} s; "
        f"steps {', '.join(f'{t:.3f}' for t in times)} ms; "
        f"{gflop / (min(times) * 1e-3) / 1e3:.3f} model TFLOP/s at the "
        f"fastest ({gflop:.1f} GFLOP a step, 3 x forward); peak memory "
        f"{peak_gb:.2f} GB; losses {[round(x, 6) for x in losses]}; "
        f"launches {got['target_attention']} target_attention, "
        f"{got['target_attention_bwd']} target_attention_bwd; every one "
        f"of {len(grads)} leaves has a finite gradient (outside the count)")
    return {k: got[k] for k in ("target_attention", "target_attention_bwd")}


def din_card_vs_cpu(seed: int) -> None:
    """DIN's smoke config trained from one init on the card and on the
    CPU, 3 steps on the same batches: SGD (momentum 0.9, lr 0.1, clip 1)
    is linear in the gradient, so the parameters differ by the gradients'
    own difference (kernels against plain versions), held to 1e-5."""
    import numpy as np
    import torch
    from repro_torch.configs import din_arch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.training.optimizer import SGD, constant_schedule
    from repro_torch.training.trainer import build_train_step, init_state
    from repro_torch.tree import leaves_with_paths

    cfg = din_arch.smoke_config()
    params = din_arch.init_smoke(torch.Generator().manual_seed(seed), cfg,
                                 "cpu")
    states = {dev: init_state(L.to_device(params, dev), SGD())
              for dev in ("cpu", "cuda")}
    step = build_train_step(lambda p, b: din_arch.smoke_loss(p, cfg, b),
                            SGD(), constant_schedule(0.1))
    rng = np.random.default_rng(seed)
    ops.reset_launches()
    for _ in range(3):
        batch = din_arch.smoke_batch(rng, cfg)
        for dev in states:
            states[dev], _ = step(states[dev], L.to_device(batch, dev))
    if ops.LAUNCHES["target_attention_bwd"] != 3:
        raise AssertionError(f"card steps launched {ops.LAUNCHES}")
    err = 0.0
    for (path, a), (_, b) in zip(leaves_with_paths(states["cuda"].params),
                                 leaves_with_paths(states["cpu"].params)):
        err = max(err, close(a, b.cuda(), 1e-5))
    log(f"din smoke_config, 3 SGD steps card vs cpu from one init: max abs "
        f"err {err:.3e} over every parameter (tol 1e-5)")


# phase 9c: the zoo's train cells.  Timed steps after one warm
# step: the LM steps take seconds each, so two; the recsys steps three
ZOO_TRAIN = {"dlrm-rm2": ("train_batch", 3), "xdeepfm": ("train_batch", 3),
             "gemma2-2b": ("train_4k", 2), "glm4-9b": ("train_4k", 2),
             "minicpm-2b": ("train_4k", 2),
             "granite-moe-1b-a400m": ("train_4k", 2),
             "olmoe-1b-7b": ("train_4k", 2)}
# the steps profiled after the count, with the kernels split out of the
# device time: the dot interaction forward and backward, the CIN forward
# and backward (its pre-passes, dx, dw and parts' sum kernels), the bf16
# flash forward and the backward's launches (namespace hw)
ZOO_TRAIN_PROFILED = {"dlrm-rm2": ("dot_interact_kernel",
                                   "dot_interact_bwd_kernel"),
                      "xdeepfm": ("cin_wgmma_kernel", "cin_bwd_"),
                      "gemma2-2b": ("flash_wgmma_kernel", "::hw::")}


def zoo_train_launches(arch: str, cell, steps: int) -> dict:
    """The launches ``steps`` steps of ``cell`` make and nothing else: a
    DLRM step one ``dot_interact`` and its backward; an xDeepFM step a
    ``cin_layer`` and a ``cin_layer_bwd`` a CIN layer; an LM step, for
    each layer and microbatch, the bf16 flash forward twice (the
    checkpointed layer runs again in the backward pass) and its backward
    once."""
    from repro_torch import configs
    mod = configs.get_arch(arch)
    if arch == "dlrm-rm2":
        return {"dot_interact": steps, "dot_interact_bwd": steps}
    if arch == "xdeepfm":
        n = len(mod.full_config().cin_layers)
        return {"cin_layer": n * steps, "cin_layer_bwd": n * steps}
    n = cell.meta["n_layers"] * cell.meta["n_microbatches"] * steps
    return {"flash_attention_wgmma": 2 * n, "flash_attention_bwd": n}


def train_zoo_cell(arch: str, seed: int) -> dict:
    """Phase 9c: ``arch``'s train cell at the full widths (DLRM-RM2 and
    xDeepFM's train_batch at B = 65,536 with no cut; the LMs' train_4k at
    their configs' cuts): one warm step and ZOO_TRAIN's timed ones, the
    counters reset before and read after (``zoo_train_launches``, nothing
    else), finite losses; ms a step, model TFLOP/s, peak GB; for the
    archs of ZOO_TRAIN_PROFILED one more step profiled (device busy, the
    kernels' shares), outside the count."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops

    shape, timed = ZOO_TRAIN[arch]
    held_gb = torch.cuda.memory_allocated() / 1e9
    cell = configs.get_arch(arch).make_cell(shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, batch = cell.make_args(seed, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, times = [], []
    for i in range(1 + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = cell.fn(state, batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    got = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    want = zoo_train_launches(arch, cell, 1 + timed)
    if got != want:
        raise AssertionError(f"{arch} {shape}: launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} {shape}: losses {losses}")
    if arch in ZOO_TRAIN_PROFILED:
        t0 = time.perf_counter()
        profile_call(f"{arch} x {shape}, one step (outside the count)",
                     lambda: cell.fn(state, batch), rows=10,
                     kernel=ZOO_TRAIN_PROFILED[arch], warmup=True)
        log(f"  (profiled in {time.perf_counter() - t0:.1f}s)")
    tflop = cell.meta["model_flops"] / 1e12
    cuts = f"cuts {cell.meta['cuts']}" if "cuts" in cell.meta else "no cut"
    log(f"{arch} x {shape} (full widths, {cuts}): set-up {setup_s:.2f} s; "
        f"steps "
        f"{', '.join(f'{t:.3f}' for t in times)} ms; "
        f"{tflop / (min(times) * 1e-3):.3f} model TFLOP/s at the fastest "
        f"({tflop * 1e3:.1f} GFLOP a step); peak memory {peak_gb:.2f} GB "
        f"({held_gb:.2f} held before the cell; {reserved_gb:.2f} reserved of "
        f"{torch.cuda.mem_get_info()[1] / 1e9:.2f}); "
        f"losses {[round(x, 6) for x in losses]}; launches {got}")
    del state, batch
    return got


def zoo_train_card_vs_cpu(seed: int) -> None:
    """Each of the five archs' smoke-width train cells from one init on
    the card and on the CPU: the loss within 1e-5 and every gradient
    within NEW_BWD_TOL of its largest magnitude (5e-5 f32; 2e-2 for the
    recsys tables' bf16 leaves); the card runs the backward kernels (the
    LMs' smoke widths are f32: the f32 flash kernels), the CPU their
    plain versions.  Then each cell's first step on both devices, the
    losses within 1e-5.  Outside the path's count."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.training.trainer import micro_value_and_grad
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    for arch, (shape, _) in ZOO_TRAIN.items():
        mod = configs.get_arch(arch)
        cfg = mod.smoke_config()
        cell = mod.make_cell(shape, cfg)
        state, batch = cell.make_args(seed, "cpu")
        if shape == "train_batch":
            batch = {k: v[:256] for k, v in batch.items()}
        n = cell.meta.get("n_microbatches", 1)
        ops.reset_launches()
        out = {}
        for dev in ("cpu", "cuda"):
            params = L.to_device(state.params, dev)
            data = L.to_device(batch, dev)
            out[dev] = micro_value_and_grad(
                lambda p, b: mod.smoke_loss(p, cfg, b), params, data, n)
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        bwd = {"dlrm-rm2": "dot_interact_bwd", "xdeepfm": "cin_layer_bwd"
               }.get(arch, "flash_attention_bwd")
        if not launched.get(bwd):
            raise AssertionError(f"{arch} smoke on the card launched "
                                 f"{launched}, no {bwd}")
        close(out["cuda"][0], out["cpu"][0].cuda(), 1e-5)
        paths = [p for p, _ in leaves_with_paths(out["cpu"][1])]
        rel, _ = close_rel(leaves(out["cuda"][1]),
                           [g.cuda() for g in leaves(out["cpu"][1])],
                           f"{arch} smoke gradients card vs cpu")
        losses = {}
        for dev in ("cpu", "cuda"):  # the step updates its state in place
            st = tree_map(lambda x: x.to(dev, copy=True), state)
            _, losses[dev] = cell.fn(st, L.to_device(batch, dev))
        close(losses["cuda"], losses["cpu"].cuda(), 1e-5)
        log(f"{arch} {shape} at smoke widths, card vs cpu from one init: "
            f"loss {float(out['cuda'][0]):.6f} vs {float(out['cpu'][0]):.6f}, "
            f"{len(paths)} gradients within {rel:.3e} of their largest "
            f"magnitude, first step's loss equal within 1e-5; card launches "
            f"{launched}")


def train_experiment(seed: int) -> dict:
    """Phase 9b: the paper's offline experiment on the card at
    tests/conftest.py's ``system_exp`` config - the four cascade models
    trained (DIN's and YDNN's gradients through the backward kernels),
    every chain simulated, the reward model trained - with the counters
    reset before the build and read after it; the claims of
    tests/test_system.py on the card-trained experiment; then the trained
    models and reward model serve ``TRAINED_WINDOWS`` windows through
    ``GeneratedSource`` over a 100,000-user ``StreamingWorld`` of the
    experiment's world and a ``ServingPipeline`` (the JAX CLI's
    ``--source generated``), on the experiment's scaled chains."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import experiments as E
    from repro_torch.core.baselines import StageActionSpace, cras_allocation
    from repro_torch.data.request_source import GeneratedSource
    from repro_torch.data.synthetic import StreamingWorld, WorldConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.serving.stream import run_stream, window_table

    cfg = E.ExperimentConfig(**{**EXP_CFG, "world": WorldConfig(
        **EXP_CFG["world"])})
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    exp = E.build_experiment(cfg, device="cuda")
    t1 = time.perf_counter()
    params, rcfg = E.train_reward_model(exp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = dict(ops.LAUNCHES)
    steps = cfg.cascade_steps
    blocks = -(-cfg.world.n_items // 256)  # score_corpus's item blocks
    want = {k: 0 for k in got}
    # training, then precompute_stage_scores over the eval and reward users
    want.update(target_attention=2 * steps + 2 * blocks,
                target_attention_bwd=2 * steps,
                embedding_bag=steps + 2, embedding_bag_bwd=steps)
    if got != want:
        raise AssertionError(f"experiment launches {got}, want {want}")
    log(f"experiment on the card (U={cfg.world.n_users} I="
        f"{cfg.world.n_items} J={exp.chains.n_chains}): cascade models, "
        f"scoring and simulation {t1 - t0:.2f} s, reward model "
        f"({cfg.reward_steps} steps) {t2 - t1:.2f} s; launches {got}; "
        f"final step losses " + ", ".join(
            f"{k} {np.mean(v[-10:]):.4f}" for k, v in exp.history.items()))

    pred = E.predicted_rewards(exp, params, rcfg, exp.ctx_eval)
    stage = E.cras_stage_rewards(exp)
    rows = E.evaluate_methods(exp, budgets_frac=(0.4, 0.5, 0.6, 0.8),
                              rewards_pred=pred, stage_rewards=stage)
    spaces = [StageActionSpace.from_chains(exp.chains, k)
              for k in range(exp.chains.n_stages)]
    for row in rows:
        best_equal = max(row["equal_din"], row["equal_dien"])
        cras = cras_allocation(stage, spaces, exp.chains, row["budget_flops"])
        cras_spend = float(exp.chains.costs[cras].sum())
        checks = {
            "oracle >= EQUAL": row["oracle"] >= best_equal,
            "oracle within budget":
                row["oracle_spend"] <= row["budget_flops"] * 1.001,
            "GreenFlow within budget":
                row["greenflow_spend"] <= row["budget_flops"] * 1.001,
            "GreenFlow >= 0.95 EQUAL": row["greenflow"] >= 0.95 * best_equal,
            # tests/test_system.py holds CRAS to running (>= 0): its
            # per-stage budget shares do not bound the total (a stage of
            # one action, recall, spends its fixed cost whatever its share)
            "CRAS runs": min(row["cras_din"], row["cras_dien"],
                             row["cras_both"]) >= 0,
            "GreenFlow >= EQUAL at mid budget":
                row["budget_frac"] != 0.5 or row["greenflow"] >= best_equal}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"experiment claims fail at budget "
                                 f"{row['budget_frac']}: {bad}; {row}")
        log(f"budget {row['budget_frac']}: oracle {row['oracle']:.0f}, "
            f"GreenFlow {row['greenflow']:.0f} (spend/budget "
            f"{row['greenflow_spend'] / row['budget_flops']:.4f}), EQUAL "
            f"DIN/DIEN {row['equal_din']:.0f}/{row['equal_dien']:.0f}, CRAS "
            f"DIN/DIEN/both {row['cras_din']:.0f}/{row['cras_dien']:.0f}/"
            f"{row['cras_both']:.0f} (spend/budget "
            f"{cras_spend / row['budget_flops']:.4f})")
    m = E.reward_model_metrics(exp, params, rcfg)
    const = float(np.mean((exp.revenue_eval - exp.revenue_reward.mean())
                          ** 2))
    if not m["mse"] < const:
        raise AssertionError(f"reward model mse {m['mse']} >= constant "
                             f"predictor's {const}")
    log(f"reward model: mse {m['mse']:.4f} (constant predictor "
        f"{const:.4f}), field-RCE {m['field_rce']:.4f}")

    world = StreamingWorld.build(dataclasses.replace(cfg.world,
                                                     n_users=100_000))
    t0 = time.perf_counter()
    source = GeneratedSource(world, exp.models, exp.chains,
                             expose=cfg.expose, seed=seed,
                             chunk=TRAINED_REQUESTS, device="cuda")
    c_max = float(exp.chains.costs.max())
    c_min = float(exp.chains.costs.min())
    budget = 0.6 * c_max * TRAINED_REQUESTS
    pipe = ServingPipeline(source.universe, params, rcfg, budget,
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ops.reset_launches()
    with torch.no_grad():
        st = run_stream(pipe, [TRAINED_REQUESTS] * TRAINED_WINDOWS, source,
                        prefetch=2, sync=torch.cuda.synchronize)
    served = dict(ops.LAUNCHES)
    for line in window_table(st):
        log(line)
    for t, r in enumerate(st.windows):
        spend, rev = float(r.spend), float(r.revenue_np.sum())
        cap = max(r.budget, r.n_valid * c_min)
        if not (spend <= cap + c_max and rev > 0
                and math.isfinite(float(r.lam_after))):
            raise AssertionError(f"trained window {t}: spend {spend} (cap "
                                 f"{cap} + {c_max}), revenue {rev}, lambda "
                                 f"{float(r.lam_after)}")
    want = {k: 0 for k in served}
    n_blocks = -(-cfg.world.n_items // source.item_block)
    want.update(cascade_truncate=TRAINED_WINDOWS,
                target_attention=n_blocks * TRAINED_WINDOWS,
                embedding_bag=TRAINED_WINDOWS)
    if served != want or st.steady_compiles:
        raise AssertionError(f"trained windows: launches {served}, want "
                             f"{want}; captures {st.compiles}")
    log(f"trained stack: source and pipeline built in {build_s:.2f} s; "
        f"{TRAINED_WINDOWS} windows of {TRAINED_REQUESTS} (scaled chains, "
        f"J = {exp.chains.n_chains}) in {st.wall_s * 1e3:.3f} ms, within "
        f"budget; launches == the eager counts {served}; captures "
        f"{st.compiles}")
    return {**{k: got[k] for k in ("target_attention", "embedding_bag",
                                   "target_attention_bwd",
                                   "embedding_bag_bwd")},
            "served": {k: served[k] for k in WINDOW_KERNELS}}


# -- phase 10: the JAX CLI on the card --------------------------------------

UNIVERSE_USERS = 100_000  # the JAX CLI's --users default
UNIVERSE_STEP = 8192  # users a window_for_users call while building it
UNIVERSE_WINDOWS = 4
CASCADE_CALLS = 3  # calls a greenflow-cascade cell
CASCADE_PARITY_USERS = 64  # rank_serve users held to the plain version
LEGACY_TOL = 1e-5  # the legacy loop's full reward matrix vs the grouped
# the committed ledgers of the JAX package and the CLI runs that make them
# with the port (results/carbon_report.csv is bench_carbon.py's phase-0
# ledger of 24 windows of 64, the others ci.yml's serving smokes)
COMMITTED_DAYS = {
    "carbon_report.csv": ["--scenario", "carbon", "--windows", "24",
                          "--requests", "64"],
    "carbon_report_geo.csv": ["--scenario", "georegions", "--windows", "6",
                              "--ci-forecast"],
    "carbon_report_geotenants.csv": [
        "--scenario", "geotenants", "--tenants", "3", "--tenant-mode",
        "priced", "--windows", "6", "--ci-forecast"],
}


class _Tee:
    """stdout to the terminal and to a buffer."""

    def __init__(self):
        import io
        self.buf = io.StringIO()

    def write(self, text):
        sys.__stdout__.write(text)
        self.buf.write(text)

    def flush(self):
        sys.__stdout__.flush()


def run_counted(label: str, fn, want: dict | None = None):
    """``fn()`` with the counters reset just before and read just after,
    its stdout kept; the launches must equal ``want`` (kernel -> count,
    every other kernel 0) when given.  Returns (result, launches, wall
    ms, stdout)."""
    import contextlib

    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    tee = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = {k: c for k, c in ops.LAUNCHES.items() if c}
    if want is not None and got != {k: c for k, c in want.items() if c}:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    log(f"{label}: wall {wall_ms:.3f} ms, launches {got}")
    return out, got, wall_ms, tee.buf.getvalue()


def table_ms(text: str, header: str, column: int) -> list[float]:
    """Column ``column`` of the window table printed after ``header``."""
    lines = text.splitlines()
    at = max(i for i, line in enumerate(lines) if line.split()[:3]
             == header.split()[:3])
    vals = []
    for line in lines[at + 1:]:
        cols = line.split()
        if not cols or not cols[0].isdigit():
            break
        vals.append(float(cols[column]))
    return vals


def time_windows(label: str, pipe, source, sizes) -> dict:
    """Serve ``sizes`` windows one at a time, synchronised: each window's
    host ms (its chunk's production, then ``serve_window``) and event ms
    (CUDA events recorded before and after ``serve_window``, so its host
    preparation is inside the span: not device busy time); the medians
    over the warm windows (no capture)."""
    import numpy as np
    import torch

    host, dev, caps = [], [], []
    streaming = hasattr(source, "window")
    for t, n in enumerate(sizes):
        h0 = time.perf_counter()
        if streaming:
            chunk = source.window(t, n)
            args = (chunk.ctx, chunk.rows)
            kw = dict(tables=chunk.tables, ready=chunk.ready)
        else:
            args, kw = source(t, n), {}
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        res = pipe.serve_window(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - h0) * 1e3)
        dev.append(e0.elapsed_time(e1))
        caps.append(res.compiles)
    warm = [i for i, c in enumerate(caps) if c == 0]
    out = {"host_ms": float(np.median([host[i] for i in warm])),
           "event_ms": float(np.median([dev[i] for i in warm])),
           "windows": len(sizes), "captures": sum(caps)}
    log(f"{label}: {len(sizes)} windows, warm medians host "
        f"{out['host_ms']:.3f} ms, event span {out['event_ms']:.3f} ms a "
        f"window (host {[round(x, 3) for x in host]}; event span "
        f"{[round(x, 3) for x in dev]}; captures {caps})")
    return out


def profile_table_window(pipe, sample, t: int, n: int) -> None:
    """One more warm window of ``n`` from the table source under
    torch.profiler, outside the count: its wall time against the
    device's busy time, idle share and cascade_truncate's share."""
    ctx, rows = sample(t, n)
    res = profile_call(f"table source, one warm window of {n} (outside "
                       f"the count)",
                       lambda: pipe.serve_window(ctx, rows, update_lam=False),
                       kernel="cascade_truncate", warmup=True)
    if res.compiles:
        raise AssertionError("the profiled table window was not warm")


def check_legacy_vs_fused(exp, server, params, rcfg, sizes) -> None:
    """On the same trained stack and windows: the legacy scorer's full
    reward matrix against the fused pass's grouped one within
    ``LEGACY_TOL``; at a pinned price, the CLI's legacy window
    (``make_legacy_window``: ``BudgetController``, then the server) and
    the fused pipeline (eager, scoring with that same full matrix)
    decide and downgrade the same, and serve the same revenue."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving.pipeline import ServingPipeline

    score = serve.make_legacy_scorer(exp, rcfg)
    budget = 0.6 * float(exp.chains.costs.max()) * sizes[0]

    class Fed(ServingPipeline):
        def _rewards(self, ctx):
            return score(params, ctx)

    grouped = ServingPipeline(server, params, rcfg, budget, graphs=False)
    fed = Fed(server, params, rcfg, budget, graphs=False)
    ctl, window = serve.make_legacy_window(exp, server, params, rcfg,
                                           budget)
    sample = serve.table_sampler(exp, seed=1)
    worst, downgraded = 0.0, 0
    for t, n in enumerate(sizes):
        ctx, rows = sample(t, n)
        full = score(params, ctx)
        with torch.no_grad():
            got = grouped._rewards(torch.as_tensor(ctx,
                                                   device=server.device))
        worst = max(worst, float(torch.max(torch.abs(got - full)
                                           / torch.clamp(torch.abs(full),
                                                         min=1.0))))
        lam = float(ctl.pd.lam)
        res = fed.serve_window(ctx, rows, lam=lam)
        dec, rev = window(ctx, rows)
        if not (np.array_equal(res.decisions_np, dec)
                and int(res.downgraded) == ctl.stats[-1].downgraded
                and np.array_equal(res.revenue_np, rev)):
            raise AssertionError(f"legacy vs fused window {t}: decisions "
                                 f"or downgrades or revenue differ at the "
                                 f"pinned price {lam}")
        downgraded += ctl.stats[-1].downgraded
    if worst > LEGACY_TOL:
        raise AssertionError(f"legacy rewards vs the fused pass's: "
                             f"{worst:.3e} > {LEGACY_TOL}")
    log(f"legacy vs fused on the trained stack: rewards within {worst:.3e} "
        f"(relative, floor 1); at the legacy controller's entry prices "
        f"decisions, downgrades ({downgraded}) and revenue equal over "
        f"{len(sizes)} windows")


def check_universe(exp, params, rcfg, seed: int, root: str) -> dict:
    """Phase 10(d): a ``UNIVERSE_USERS``-user universe of the trained
    stack's streamed world, its tables made by ``GeneratedSource.
    window_for_users`` in steps of ``UNIVERSE_STEP`` users, saved, loaded
    memmapped with its tables on the device and without; each window's
    users, contexts and tables equal ``GeneratedSource``'s bit for bit,
    and so do the windows served from each (decisions, revenue, spend,
    price).  Returns the launches, checked against the source's chunk
    count, and the times."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.data.request_source import (GeneratedSource,
                                                 TableReplaySource)
    from repro_torch.data.synthetic import StreamingWorld
    from repro_torch.kernels import ops
    from repro_torch.serving.pipeline import ServingPipeline

    dev = params["label_norm"].device
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    world = StreamingWorld.build(dataclasses.replace(
        exp.cfg.world, n_users=UNIVERSE_USERS))
    gen = GeneratedSource(world, exp.models, exp.chains,
                          expose=exp.cfg.expose, seed=seed, device=dev)
    lay = gen.universe.compact
    g_n, cap, u_n = len(lay.p_sorted), lay.cap, UNIVERSE_USERS
    ctx = np.empty((u_n, gen.d_context), np.float32)
    p = np.empty((g_n, u_n, cap), np.int32)
    ck = np.empty((g_n, u_n, cap), np.float32)
    for lo in range(0, u_n, UNIVERSE_STEP):
        hi = min(u_n, lo + UNIVERSE_STEP)
        chunk = gen.window_for_users(np.arange(lo, hi))
        if chunk.ready is not None:
            chunk.ready.synchronize()
        ctx[lo:hi] = chunk.ctx
        p[:, lo:hi] = chunk.tables["p"].cpu().numpy()
        ck[:, lo:hi] = chunk.tables["ck"].cpu().numpy()
    build_s = time.perf_counter() - t0
    path = os.path.join(root, "universe")
    t0 = time.perf_counter()
    TableReplaySource(ctx, p, ck, exp.chains, n_items=exp.cfg.world.n_items,
                      expose=exp.cfg.expose, seed=seed,
                      device=dev).save(path)
    save_s = time.perf_counter() - t0
    nbytes = p.nbytes + ck.nbytes
    del ctx, p, ck
    on = TableReplaySource.load(path, exp.chains, seed=seed,
                                device_tables=True, device=dev)
    off = TableReplaySource.load(path, exp.chains, seed=seed, device=dev)
    if not (isinstance(on.p_sorted, np.memmap) and on.device_tables
            and not off.device_tables and on.n_users == u_n):
        raise AssertionError("the universe did not load memmapped")
    n = 512
    for t in range(UNIVERSE_WINDOWS):
        want = gen.window(t, n)
        if want.ready is not None:
            want.ready.synchronize()
        for name, src in (("device tables", on), ("host tables", off)):
            got = src.window(t, n)
            same = (np.array_equal(got.users, want.users)
                    and np.array_equal(got.ctx, want.ctx)
                    and all(torch.equal(torch.as_tensor(got.tables[k],
                                                        device=dev),
                                        want.tables[k])
                            for k in ("p", "ck")))
            if not same:
                raise AssertionError(f"universe window {t} ({name}) differs "
                                     f"from GeneratedSource's")
    budget = 0.6 * float(exp.chains.costs.max()) * n
    runs = {}
    for name, src in (("generated", gen), ("device tables", on),
                      ("host tables", off)):
        pipe = ServingPipeline(src.universe, params, rcfg, budget)
        runs[name] = [pipe.serve_window(c.ctx, c.rows, tables=c.tables,
                                        ready=c.ready)
                      for c in (src.window(100 + t, n)
                                for t in range(UNIVERSE_WINDOWS))]
    torch.cuda.synchronize()
    for name in ("device tables", "host tables"):
        for t, (a, b) in enumerate(zip(runs["generated"], runs[name])):
            for f in ("decisions", "revenue", "spend", "lam_after",
                      "downgraded"):
                if not torch.equal(getattr(a, f), getattr(b, f)):
                    raise AssertionError(f"universe window {100 + t} "
                                         f"({name}): {f} differs from the "
                                         f"generated window's")
    got = {k: c for k, c in ops.LAUNCHES.items() if c}
    # and on the card the capture's warm-up on the zero batch
    chunks = gen.cache_misses + (dev.type == "cuda")
    blocks = -(-exp.cfg.world.n_items // gen.item_block)
    want = {"target_attention": blocks * chunks, "embedding_bag": chunks,
            "cascade_truncate": 3 * UNIVERSE_WINDOWS}
    if got != want:
        raise AssertionError(f"universe: launches {got}, want {want}")
    log(f"universe of {u_n:,} users (G = {g_n}, cap = {cap}, "
        f"{nbytes / 1e9:.3f} GB of tables, {nbytes / u_n:.0f} bytes a "
        f"user): scored and gathered in {build_s:.2f} s, saved in "
        f"{save_s:.2f} s; memmapped windows with the tables on the device "
        f"and on the host == GeneratedSource's bit for bit (users, ctx, "
        f"tables) over {UNIVERSE_WINDOWS} windows of {n}, and so are the "
        f"windows served from each (decisions, revenue, spend, price); "
        f"launches {got}")
    gen.close()
    return {"launches": got, "build_s": build_s, "save_s": save_s,
            "gb": nbytes / 1e9}


def compare_committed(name: str, path: str) -> None:
    """Each column's largest relative difference between the port's
    ledger CSV and the JAX package's committed one (information: the
    committed ledgers came from JAX-trained models)."""
    import csv

    with open(os.path.join(ROOT, "results", name)) as f:
        want = list(csv.reader(f))
    with open(path) as f:
        got = list(csv.reader(f))
    if got[0] != want[0]:
        log(f"{name}: columns differ ({got[0]} vs {want[0]})")
        return
    worst = {}
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(want[0], g_row, w_row):
            try:
                g, w = float(g), float(w)
            except ValueError:
                continue
            rel = abs(g - w) / max(abs(g), abs(w)) if g != w else 0.0
            worst[col] = max(worst.get(col, 0.0), rel)
    log(f"{name} vs the committed JAX ledger ({len(got) - 1} rows here, "
        f"{len(want) - 1} there), largest |a - b| / max(|a|, |b|) a "
        f"column: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def serve_cascade_cells(seed: int) -> dict:
    """Phase 10(f): greenflow-cascade's four cells at ``full_config()``,
    ``CASCADE_CALLS`` calls each, the counters reset before and read
    after each cell (``rank_serve``: one ``target_attention`` launch a
    call, at B = 1,024 x 200 candidates; the others no kernel of the
    repository); ms a call and model TFLOP/s; then, outside the count,
    ``rank_serve``'s kernel against its plain version on the first
    ``CASCADE_PARITY_USERS`` users (its (B, N, T, 4d) features would take
    5.9 GB at full B).  Returns the launches and the times."""
    import torch
    from repro_torch.configs import greenflow_cascade as gfc
    from repro_torch.kernels import ops, ref
    from repro_torch.models.recsys import din

    out = {}
    for shape in gfc.SHAPES:
        cell = gfc.make_cell(shape)
        args = cell.make_args(seed, "cuda")
        torch.cuda.synchronize()
        ops.reset_launches()
        ms = []
        for _ in range(CASCADE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cell.fn(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if cell.kind == "train":
                args = (res[0], *args[1:])
            outs = res[1:] if cell.kind == "train" else (
                res if isinstance(res, tuple) else (res,))
            if not all(torch.isfinite(o.float()).all() for o in outs):
                raise AssertionError(f"greenflow-cascade {shape}: not "
                                     f"finite")
        got = {k: c for k, c in ops.LAUNCHES.items() if c}
        want = ({"target_attention": CASCADE_CALLS}
                if shape == "rank_serve" else {})
        if got != want:
            raise AssertionError(f"greenflow-cascade {shape}: launches "
                                 f"{got}, want {want}")
        flops = cell.meta["model_flops"]
        out[shape] = {"ms": ms, "tflops": flops / (min(ms) * 1e-3) / 1e12,
                      "launches": got}
        log(f"greenflow-cascade {shape} (full_config, {cell.meta}): ms a "
            f"call {[round(x, 3) for x in ms]}, {out[shape]['tflops']:.3f} "
            f"model TFLOP/s at the fastest; launches {got}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if shape == "rank_serve":
            params, user, cid, ccat = args
            m = CASCADE_PARITY_USERS
            keys = din.embed_items(params, user["hist_ids"][:m],
                                   user["hist_cats"][:m])
            q = din.embed_candidates(params, cid[:m], ccat[:m])
            ws = din._attn_weights(params)
            with torch.no_grad():
                got_k = ops.target_attention(q, keys, user["hist_mask"][:m],
                                             *ws)
                want_k = ref.target_attention_ref(q, keys,
                                                  user["hist_mask"][:m], *ws)
            err = close(got_k, want_k, 2e-5)
            # the kernel alone at the cell's full shape, and its bound
            keys = din.embed_items(params, user["hist_ids"],
                                   user["hist_cats"])
            q = din.embed_candidates(params, cid, ccat)
            mask = user["hist_mask"]
            with torch.no_grad():
                k_ms = cuda_ms(lambda: ops.target_attention(q, keys, mask,
                                                            *ws), reps=10)
            (b_ms, by), f32_ms = attention_bound(q, mask, ws[0].shape[1],
                                                 ws[2].shape[1])
            out[shape].update(kernel_ms=k_ms, bound_ms=b_ms, max_abs_err=err)
            log(f"rank_serve's target_attention on its first {m} users "
                f"(N = {cid.shape[1]}, two candidate blocks of 128, the "
                f"second partly empty) vs the plain version: max_abs_err "
                f"{err:.3e} (tolerance 2e-5); the kernel alone at "
                f"B = {q.shape[0]} x N = {q.shape[1]}: {k_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {by} ({b_ms / k_ms:.1%}; all in f32 "
                f"{f32_ms:.4f})")
        del cell, args, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_trained_cli(seed: int, build_s: float) -> dict:
    """Phase 10: the JAX package's serving CLI on the card, on the trained
    stack of ``serve_config(small=False)`` (trained in phase 4c into the
    smoke's experiment cache): (a) ``serve.main([])``, the CLI's defaults
    (12 spike windows of 96 over ``--source table``); (b) the legacy host
    loop and the carbon legacy loop on the same stack, and the legacy
    rewards and decisions against the fused pass's; (c) ``--source
    memmap`` twice through the CLI, the first saving the universe; timed
    windows of the table, memmap and generated sources; (d) a
    100,000-user universe (``check_universe``); (e) the three carbon days
    through the CLI at the committed ledgers' commands (``--small``,
    trained here), compared with them as information; (f) the four
    greenflow-cascade cells.  Every step's launches are counted and
    checked against its eager counts; returns the phase's launches."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import experiments as E
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    cfg = E.serve_config()
    sizes = serve.scenario_sizes("spike", 12, 96)
    built = build_launches(cfg)
    total: dict = {}

    def add(got):
        for k, c in got.items():
            total[k] = total.get(k, 0) + c

    with tempfile.TemporaryDirectory(prefix="cli-") as root:
        # (a) the CLI's defaults
        _, got, _, text = run_counted(
            "(a) serve.main([]) (table source, 12 spike windows of 96)",
            lambda: serve.main([]),
            {**built, "cascade_truncate": len(sizes)})
        add(got)
        cli_ms = table_ms(text, "win n spend/budget", 6)
        log(f"(a) the CLI's window ms (host, to the device's end): {cli_ms}")
        # the stack itself, for (b), the timings and (d)
        (exp, server, params, rcfg), got, _, _ = run_counted(
            "the trained stack from the cache",
            lambda: E.build_serving_stack(cfg, device="cuda"), built)
        add(got)
        # (b) the legacy loops on the same stack
        budget = 0.6 * float(exp.chains.costs.max()) * 96
        _, got, _, text = run_counted(
            "(b) the legacy host loop (BudgetController, table source)",
            lambda: serve._legacy_loop(exp, server, params, rcfg, sizes,
                                       budget),
            {"cascade_truncate": len(sizes)})
        add(got)
        legacy_ms = table_ms(text, "win n spend/budget", 6)
        args = serve.parser().parse_args([
            "--scenario", "carbon", "--legacy", "--carbon-report",
            os.path.join(root, "legacy_carbon.csv")])
        carbon = serve.trained_stack(exp, server, params, rcfg,
                                     scenario="carbon")
        _, got, _, _ = run_counted(
            "(b) the carbon legacy loop (CarbonBudgetController, ledger)",
            lambda: serve.legacy_carbon_day(carbon, args),
            {"cascade_truncate": len(serve._day_sizes(args))})
        add(got)
        check_legacy_vs_fused(exp, server, params, rcfg, sizes)
        # (c) the memmap replay through the CLI, twice
        replay = os.path.join(root, "replay")
        for k in range(2):
            _, got, _, text = run_counted(
                f"(c) serve.main --source memmap, run {k + 1}",
                lambda: serve.main(["--source", "memmap", "--replay-dir",
                                    replay]),
                {**built, "cascade_truncate": len(sizes)})
            add(got)
            if ("saving replay universe" in text) != (k == 0):
                raise AssertionError("the first memmap run saves, the "
                                     "second loads")
        # the windows' times on each source
        timed = {}
        for source in ("table", "memmap", "generated"):
            stack = serve.trained_stack(exp, server, params, rcfg,
                                        source=source, replay_dir=replay,
                                        seed=seed)
            misses = getattr(stack.source, "cache_misses", 0)
            timed[source], got, _, _ = run_counted(
                f"timed windows, {source} source",
                lambda: time_windows(f"{source} source, 12 spike windows",
                                     stack.pipeline, stack.source, sizes))
            add(got)
            # a generated source captured its scoring when it was built,
            # before the count: each chunk served is one miss
            chunks = getattr(stack.source, "cache_misses", 0) - misses
            want = {"cascade_truncate": len(sizes),
                    "target_attention": -(-cfg.world.n_items // 256) * chunks,
                    "embedding_bag": chunks}
            if {k: c for k, c in want.items() if c} != got:
                raise AssertionError(f"timed {source} windows: launches "
                                     f"{got}, want {want}")
            if source == "table":
                profile_table_window(stack.pipeline, stack.source,
                                     len(sizes), max(sizes))
            del stack
        log(f"legacy loop ms a window (host, synchronous): {legacy_ms}; "
            f"median {float(np.median(legacy_ms[1:])):.3f} against the "
            f"fused table source's {timed['table']['host_ms']:.3f} host / "
            f"{timed['table']['event_ms']:.3f} event span")
        # (d) the 100,000-user universe
        universe = check_universe(exp, params, rcfg, seed, root)
        add(universe["launches"])
        del exp, server, params
        gc.collect()
        torch.cuda.empty_cache()
        # (e) the carbon days at the committed ledgers' commands
        small = E.serve_config(small=True)
        for k, (name, argv) in enumerate(COMMITTED_DAYS.items()):
            path = os.path.join(serve.RESULTS, name)
            n_w = int(argv[argv.index("--windows") + 1])
            # the small stack trains in the first run, loads after
            want = dict(train_launches(small) if k == 0
                        else build_launches(small))
            want["cascade_truncate"] = n_w
            _, got, _, _ = run_counted(
                f"(e) serve.main --small {' '.join(argv)}",
                lambda: serve.main(["--small", *argv]), want)
            add(got)
            if not os.path.exists(path):
                raise AssertionError(f"(e) no ledger at {path}")
            compare_committed(name, path)
        # (f) the greenflow-cascade cells
        cells = serve_cascade_cells(seed)
        for c in cells.values():
            add(c["launches"])
    log(f"phase 10: wall {time.perf_counter() - t_phase:.1f} s; launches "
        f"{total}; the trained stack's training {build_s:.2f} "
        f"s on the card (phase 4c); window ms (host / event span, warm "
        f"medians): " + ", ".join(
            f"{k} {v['host_ms']:.3f} / {v['event_ms']:.3f}"
            for k, v in timed.items()))
    return total


def window_inputs(seed: int, dev):
    """The window's history slab (512 users of the full-width world), the
    CompactPlan layout of its chains, and the world's config."""
    import numpy as np
    import torch
    from repro_torch.cascade.engine import build_compact_layout
    from repro_torch.data.synthetic import StreamingWorld
    from repro_torch.launch import serve

    wcfg = serve.world_config(512, seed=seed)
    slab = StreamingWorld.build(wcfg).user_slab(np.arange(512))
    hist_ids = torch.from_numpy(slab.hist_ids).int().to(dev)
    hist_mask = torch.from_numpy(slab.hist_mask).to(dev)
    chains = serve.build_chains(wcfg, serve.FULL_EXPOSE)
    layout = build_compact_layout(chains, n_items=wcfg.n_items,
                                  expose=serve.FULL_EXPOSE)
    return wcfg, hist_ids, hist_mask, layout


# -- phase 11: multi-process serving on the card -------------------------------


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_procs(cmds: list, *, timeout: float, env: dict | None = None,
              label: str = "") -> list[str]:
    """Start every command at once, wait for all of them and return
    their outputs; if one fails or the time runs out, kill every one
    still running and raise with the failed one's output."""
    import subprocess
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env=env) for c in cmds]
    outs = []
    try:
        t_end = time.monotonic() + timeout
        for p in procs:
            o, _ = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            outs.append(o)
            if p.returncode != 0:
                raise AssertionError(f"{label} process {len(outs) - 1} "
                                     f"exited {p.returncode}:\n{o[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def child_cmd(kind: str, **kw) -> list:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", kind]
    for k, v in kw.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]
    return cmd


def probe_child(args) -> int:
    """Phase 11 (a)'s member: join a two-process gloo group, stage a
    CUDA tensor through the host and gather it."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{args.port}", world_size=args.world,
                            rank=args.rank, timeout=timedelta(seconds=120))
    dev = torch.device("cuda", args.rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    x = torch.full((4,), float(args.rank + 1), device=dev)
    host = x.cpu()
    out = [torch.empty_like(host) for _ in range(args.world)]
    dist.all_gather(out, host)
    got = torch.stack(out).to(dev)
    want = torch.arange(1, args.world + 1, dtype=torch.float32,
                        device=dev)[:, None].expand(-1, 4)
    if not torch.equal(got, want):
        raise AssertionError(f"rank {args.rank} gathered {got.tolist()}")
    print(json.dumps({"rank": args.rank, "device": str(dev),
                      "name": torch.cuda.get_device_name(dev),
                      "gathered": got[:, 0].tolist()}), flush=True)
    dist.destroy_process_group()
    return 0


def probe_processes() -> dict:
    """Phase 11 (a): the card's compute mode, then two processes on the
    card that form a gloo group and gather a CUDA tensor staged through
    the host.  A card that refuses a second process fails here."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    mode = out.stdout.strip()
    log(f"phase 11 (a): card and compute mode: {mode}")
    port = free_port()
    t0 = time.perf_counter()
    outs = run_procs([child_cmd("probe", rank=r, world=2, port=port)
                      for r in range(2)], timeout=180, label="probe")
    rows = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    wall = time.perf_counter() - t0
    log(f"phase 11 (a): two processes on the card gathered over gloo "
        f"through the host: {rows} in {wall:.1f}s")
    return {"compute_mode": mode, "rows": rows, "wall_s": wall}


def mh_child_module():
    """``tests/torch_mh_child.py``: the cheap replay stack's member
    process and its launcher, shared with the CPU tests."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_mh_child
    return torch_mh_child


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + int(v)


def serve_cheap_processes(tmp: str) -> dict:
    """Phase 11 (b): the cheap replay stack of tests/test_multihost.py at
    S = 8 on the card: the plain stream in one process and over 2 and 4,
    geotenants in one and over 2, and the elastic resume (2 processes
    serve windows 0-2 and checkpoint, 4 resume at 3-5, then one resumes
    the same checkpoint); every host's prices and spends equal the
    one-process run's bit for bit, the hosts' rows stitch to its
    decisions and regions, zero steady-state captures everywhere.
    Returns the children's launches (one truncation a window a shard)."""
    mhc = mh_child_module()
    t0 = time.perf_counter()
    first = [mhc.start(1, "plain,geotenants", tmp, "ref", device="cuda"),
             mhc.start(2, "plain,geotenants,a", tmp, "p2", device="cuda")]
    ref, p2 = (mhc.finish(g, timeout=300) for g in first)
    second = [mhc.start(4, "plain,b", tmp, "p4", device="cuda"),
              mhc.start(1, "b", tmp, "down", device="cuda")]
    p4, down = (mhc.finish(g, timeout=300) for g in second)
    ref = ref[0]
    mhc.assert_group_matches(ref, p2, "plain")
    mhc.assert_group_matches(ref, p4, "plain")
    mhc.assert_group_matches(ref, p2, "geotenants")
    mhc.assert_group_matches(ref, p2, "a", "plain")
    mhc.assert_group_matches(ref, p4, "b", "plain", ref_offset=3)
    mhc.assert_group_matches(ref, down, "b", "plain", ref_offset=3)
    launches: dict = {}
    checked: set = set()
    for h in [ref, *p2, *p4, *down]:
        local = h["host"]["local_shards"]
        if h["host"]["platform"] != "gpu":
            raise AssertionError(f"a member served off the card: {h['host']}")
        for job, d in h["jobs"].items():
            if not d["truncation_rows"]:
                raise AssertionError(f"{job} {h['host']}: the truncation "
                                     f"was not held to its plain version")
            checked.update(d["truncation_rows"])
            if d["steady_compiles"] != 0:
                raise AssertionError(f"{job} {h['host']}: steady captures "
                                     f"{d['compiles']}")
            want = {"cascade_truncate": len(d["windows"]) * local}
            got = {k: v for k, v in d["launches"].items() if v}
            if got != want:
                raise AssertionError(f"{job} {h['host']}: launches {got}, "
                                     f"eager counts {want}")
            add_launches(launches, got)
    log(f"phase 11 (b): cheap stack at S = 8 on the card, plain over 1 / 2 "
        f"/ 4 processes, geotenants over 1 / 2, elastic 2 -> 4 -> 1: every "
        f"host bitwise the one-process run, zero steady captures, "
        f"cascade_truncate == its plain version at the per-shard rows "
        f"{sorted(checked)}, launches {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    return launches


def full_child(args) -> int:
    """Phase 11 (c)'s member: phase 4's full-width stack on a request mesh
    of ``--shards`` shards over ``--world`` processes, 6 spike windows
    through the CUDA graphs with prefetch 2, synchronised after each;
    writes its digest, times, launches and memory to ``--out``."""
    import torch
    from repro_torch.distributed import multihost as mh
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_request_mesh

    if args.world > 1:
        mh.initialize(coordinator=f"127.0.0.1:{args.port}",
                      num_processes=args.world, process_id=args.rank)
    mesh = make_request_mesh(args.shards)
    t0 = time.perf_counter()
    stack = serve.build_stack(users=100_000, requests=args.requests,
                              windows=args.windows, scenario="spike",
                              seed=args.seed, device="cuda", mesh=mesh)
    build_s = time.perf_counter() - t0
    pipe = stack.pipeline
    spans = []
    serve_window = pipe.serve_window

    def timed(*a, **kw):  # the CUDA events' span around serve_window
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        res = serve_window(*a, **kw)
        e.record()
        spans.append((s, e))
        return res

    pipe.serve_window = timed
    waits, gathers = [], []
    gather = pipe._gather_rewards

    def timed_gather(*a):  # host ms: own scoring's wait, then the exchange
        g0 = time.perf_counter()
        torch.cuda.current_stream().synchronize()
        g1 = time.perf_counter()
        gather(*a)
        waits.append((g1 - g0) * 1e3)
        gathers.append((time.perf_counter() - g1) * 1e3)

    if mesh.world > 1:  # one process has no exchange (and no sync)
        pipe._gather_rewards = timed_gather
    misses = stack.source.cache_misses
    torch.cuda.synchronize()
    ops.reset_launches()
    st = serve.serve(stack, sync=True, prefetch=2)
    launches = dict(ops.LAUNCHES)
    chunks = stack.source.cache_misses - misses
    truncation_rows = mh_child_module().check_truncation(pipe, st.windows)
    c_min = float(stack.chains.costs.min())
    for t, r in enumerate(st.windows):
        spend, lam = float(r.spend), float(r.lam_after)
        if not spend <= max(r.budget, r.n_valid * c_min) + stack.c_max:
            raise AssertionError(f"window {t}: spend {spend} over budget")
        if not math.isfinite(lam):
            raise AssertionError(f"window {t}: lambda {lam} not finite")
    out = {"host": mh.host_report(mesh), "build_s": build_s,
           "windows": [mh_child_module().window_digest(r)
                       for r in st.windows],
           "revenue": [float(r.revenue_np.sum()) for r in st.windows],
           "host_ms": list(st.submit_ms),
           "device_ms": [s.elapsed_time(e) for s, e in spans],
           "score_wait_ms": waits, "gather_ms": gathers,
           "truncation_rows": truncation_rows,
           "wall_s": st.wall_s, "launches": launches, "chunks": chunks,
           "n_blocks": -(-stack.source._n_items()
                         // stack.source.item_block),
           "steady_compiles": st.steady_compiles, "compiles": st.compiles,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    with open(args.out, "w") as f:
        json.dump(out, f)
    mh.shutdown()
    return 0


def serve_full_processes(tmp: str, args) -> dict:
    """Phase 11 (c): phase 4's world at full width (100,000 users, J =
    128, DIN and DIEN at the published config), 6 spike windows at S = 2:
    one process first, alone (each process holds its own scoring graphs,
    about 20 GB of pool), then two processes on the card; every host
    bitwise the one-process run, zero steady captures, each host's
    launches its eager counts.  Returns the launches of both runs."""
    mhc = mh_child_module()
    runs = {}
    for world in (1, 2):
        port = free_port()
        t0 = time.perf_counter()
        outs = [os.path.join(tmp, f"full_{world}_{r}.json")
                for r in range(world)]
        run_procs([child_cmd("full", rank=r, world=world, port=port,
                             shards=2, out=outs[r], seed=args.seed,
                             windows=args.windows, requests=args.requests)
                   for r in range(world)], timeout=600,
                  label=f"full width over {world}")
        runs[world] = [json.load(open(o)) for o in outs]
        log(f"phase 11 (c): {world} process(es) at S = 2 in "
            f"{time.perf_counter() - t0:.1f}s")
    ref = {"jobs": {"full": runs[1][0]}}
    hosts = [{"host": h["host"], "jobs": {"full": h}} for h in runs[2]]
    mhc.assert_group_matches(ref, hosts, "full")
    launches: dict = {}
    for h in runs[1] + runs[2]:
        rep = h["host"]
        if h["steady_compiles"] != 0:
            raise AssertionError(f"{rep}: steady captures {h['compiles']}")
        want = {"cascade_truncate": len(h["windows"]) * rep["local_shards"],
                "target_attention": h["n_blocks"] * h["chunks"],
                "embedding_bag": h["chunks"]}
        got = {k: v for k, v in h["launches"].items() if v}
        if got != want:
            raise AssertionError(f"{rep}: launches {got}, eager {want}")
        if not {256, 768} <= set(h["truncation_rows"]):
            raise AssertionError(f"{rep}: the truncation was held to its "
                                 f"plain version at {h['truncation_rows']} "
                                 f"rows, not at 256 and 768")
        add_launches(launches, got)
        log(f"phase 11 (c) host {rep['process_index']} of "
            f"{rep['process_count']}: build {h['build_s']:.1f}s, host ms "
            f"{[round(x, 3) for x in h['host_ms']]}, device ms (event span "
            f"around serve_window) {[round(x, 3) for x in h['device_ms']]}, "
            f"own scoring's wait before the gather ms "
            f"{[round(x, 3) for x in h['score_wait_ms']]}, gather ms (the "
            f"exchange alone) {[round(x, 3) for x in h['gather_ms']]}, "
            f"cascade_truncate == its plain version at "
            f"{h['truncation_rows']} rows a shard, wall "
            f"{h['wall_s'] * 1e3:.3f} ms, launches {got} ({h['chunks']} "
            f"scoring chunks), peak reserved {h['peak_reserved_gb']:.2f} GB "
            f"(allocated {h['peak_allocated_gb']:.2f} GB), revenue "
            f"{[round(x, 1) for x in h['revenue']]}")
    log(f"phase 11 (c): two processes at full width bitwise the "
        f"one-process S = 2 run (prices, spends, stitched decisions)")
    return launches


def serve_cli_processes(tmp: str) -> dict:
    """Phase 11 (d): the CLI over two processes.  The JAX CLI's refusals
    first (before any training); then the ``--small`` trained stack built
    in this run's experiment cache, which the CLI processes only load;
    ``--shards 2`` in one process and ``--processes 2`` at once: equal
    reward-parameter digests, and every window's price and spend in the
    ``.host0`` and ``.host1`` flight logs equal to the ``--shards 2``
    run's."""
    import torch
    from repro_torch import experiments
    from repro_torch.launch import serve

    refusals = {
        ("--source", "table"): "--processes needs a streaming --source",
        ("--legacy",): "--legacy is single-process",
        ("--source", "generated", "--shards", "2"): "drop --shards"}
    build = experiments.build_serving_stack

    def no_training(*a, **kw):
        raise AssertionError("the CLI trained before refusing")

    experiments.build_serving_stack = no_training
    try:
        for argv, msg in refusals.items():
            try:
                serve.main(["--small", "--processes", "2", "--coordinator",
                            "127.0.0.1:1", *argv])
            except SystemExit as e:
                if msg not in str(e):
                    raise AssertionError(f"{argv}: refused with {e}")
            else:
                raise AssertionError(f"{argv} was not refused")
    finally:
        experiments.build_serving_stack = build
    t0 = time.perf_counter()
    build(experiments.serve_config(small=True), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    env = dict(os.environ, REPRO_TORCH_CACHE=experiments.CACHE,
               PYTHONPATH=os.path.join(ROOT, "src"))
    port = free_port()
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--small",
            "--source", "generated", "--windows", "6"]
    one = os.path.join(tmp, "cli_one.prom")
    two = os.path.join(tmp, "cli_two.prom")
    t0 = time.perf_counter()
    outs = run_procs(
        [base + ["--shards", "2", "--metrics-out", one]]
        + [base + ["--processes", "2", "--process-id", str(r),
                   "--coordinator", f"127.0.0.1:{port}", "--metrics-out",
                   two] for r in range(2)],
        timeout=400, env=env, label="CLI")
    wall = time.perf_counter() - t0
    digests = [next(line.split()[-1] for line in o.splitlines()
                    if line.startswith("[serve] reward params sha256"))
               for o in outs]
    if len(set(digests)) != 1:
        raise AssertionError(f"reward parameters differ: {digests}")

    def rows(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    want = [(r["lam"], r["spend"]) for r in rows(one + ".windows.jsonl")]
    for h in range(2):
        got = rows(f"{two}.host{h}.windows.jsonl")
        if [(r["lam"], r["spend"]) for r in got] != want or \
                any(r["host"] != f"host{h}" for r in got):
            raise AssertionError(f"host{h}'s window log differs from "
                                 f"--shards 2's")
    log(f"phase 11 (d): the --small stack trained in {build_s:.1f}s; "
        f"--shards 2 and --processes 2 (3 processes at once) in "
        f"{wall:.1f}s: reward params sha256 {digests[0][:16]}... on all, "
        f"{len(want)} windows' prices and spends equal in host0's and "
        f"host1's logs; refusals before training: {list(refusals.values())}")
    return {"build_s": build_s, "wall_s": wall}


def serve_processes(args) -> dict:
    """Phase 11: multi-process serving on the card (a)-(d).  Returns the
    launches of (b) and (c)'s member processes."""
    import shutil
    import tempfile

    import torch
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke-mh-")
    try:
        probe_processes()
        launches = serve_cheap_processes(tmp)
        gc.collect()
        torch.cuda.empty_cache()
        add_launches(launches, serve_full_processes(tmp, args))
        serve_cli_processes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 11: {time.perf_counter() - t0:.1f}s, member launches "
        f"{launches}")
    return launches


CHILDREN = {"probe": probe_child, "full": full_child}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    # phase 11's member processes (started by this script itself)
    ap.add_argument("--child", choices=tuple(CHILDREN), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--shards", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if args.child is not None:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 2
        return CHILDREN[args.child](args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.obs.env import card_line

    t_smoke = time.perf_counter()
    card = card_line()
    if card is None:
        raise RuntimeError("nvidia-smi reported no card")
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s "
        f"(torch.utils.cpp_extension, into {build.build_dir()})")

    # the CLI's trained stacks train into an experiment cache of this
    # run's own (phase 4c, phase 10), never one left by an earlier run
    import shutil
    import tempfile

    from repro_torch import experiments
    experiments.CACHE = tempfile.mkdtemp(prefix="smoke-cache-")
    dev = torch.device("cuda")
    # pins PyTorch's default, full f32 in f32 products, which the f32
    # checks (2e-5, 1e-5, the f32 serve-path identity) and compiled
    # flex_attention's f32 rows rely on
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed)
    # the main path's history bags: a real slab of the full-width world
    wcfg, hist_ids, hist_mask, layout = window_inputs(args.seed, dev)
    t_phase = time.perf_counter()
    results = {
        "cascade_truncate": check_truncation(gen, dev, layout,
                                             serve.FULL_EXPOSE),
        "target_attention": check_target_attention(gen, dev, hist_mask),
        "embedding_bag": check_embedding_bag(gen, dev, hist_ids, hist_mask,
                                             wcfg.n_items, 32),
        "dot_interact": check_dot_interact(dev),
        "cin_layer": check_cin(dev),
        **check_flash(dev),
        "target_attention_bwd": check_target_attention_bwd(gen, dev),
        "embedding_bag_bwd": check_embedding_bag_bwd(
            gen, dev, hist_ids, hist_mask, wcfg.n_items, 32),
        "dot_interact_bwd": check_dot_interact_bwd(dev),
        "cin_layer_bwd": check_cin_bwd(dev),
        "flash_attention_bwd": check_flash_bwd(dev),
    }
    log(f"phase 3 (the kernels against their plain versions): "
        f"{time.perf_counter() - t_phase:.1f}s")
    for name, r in results.items():
        log(f"{name} [{r['shape']}]: max_abs_err {r['max_abs_err']:.3e}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    floor_ms = launch_floor_ms(dev)
    bag = results["embedding_bag"]
    log(f"graph-replayed device ms: cascade_truncate "
        f"{results['cascade_truncate']['device_ms']:.5f}, embedding_bag "
        f"{bag['device_ms']:.5f}, F.embedding_bag "
        f"{bag['library_device_ms']:.5f} (eager {bag['library_ms']:.5f}), "
        f"embedding_bag_bwd {results['embedding_bag_bwd']['device_ms']:.5f}; "
        f"launch floor (one-element add_) {floor_ms:.5f}")
    stack, st, launches = serve_full(args)
    n_windows = len(st.windows)
    profile_window(stack)
    multi_launches = serve_multi_price(stack)
    days = serve_carbon_days(stack)
    trained_build, build_s = days.pop("trained stack build"), \
        days.pop("build_s")
    multi_launches.update({f"{name} day": c for name, c in days.items()})
    del stack, st
    gc.collect()  # the programs' closures form cycles; free their graphs
    torch.cuda.empty_cache()
    log(f"graphs released: {torch.cuda.memory_reserved() / 1e9:.3f} GB "
        f"reserved")
    zoo_launches = serve_zoo(args.seed)
    small_parity(args.seed)
    zoo_parity(args.seed)
    t_phase = time.perf_counter()
    serve_bst(args.seed)
    train_schnet(args.seed)
    log(f"phases 6b-6c (BST, SchNet): {time.perf_counter() - t_phase:.1f}s")
    lm_launches, f32_launches = serve_lm(args.seed)
    torch.cuda.empty_cache()
    lm_launches += serve_lm_cells(args.seed)
    lm_parity(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dense = serve_dense_lms(args.seed)
    log(f"phase 8b (glm4-9b, minicpm-2b): "
        f"{time.perf_counter() - t_phase:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    moe = serve_moe_lms(args.seed)
    moe_s = time.perf_counter() - t_phase
    log(f"phase 8c (granite-moe-1b-a400m, olmoe-1b-7b): {moe_s:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    din_train = train_din_full(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    experiment = train_experiment(args.seed)
    din_card_vs_cpu(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    zoo_train = {}
    for arch in ZOO_TRAIN:
        t0 = time.perf_counter()
        zoo_train[arch] = train_zoo_cell(arch, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        if arch in MOE_LMS:
            moe_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo_train_card_vs_cpu(args.seed)
    log(f"phase 9c ({', '.join(ZOO_TRAIN)} training): "
        f"{time.perf_counter() - t_phase:.1f}s (the card-vs-CPU checks "
        f"{time.perf_counter() - t0:.1f}s)")
    log(f"the MoE LMs' phases (8c and their 9c train cells): {moe_s:.1f}s")
    cli = serve_trained_cli(args.seed, build_s)
    gc.collect()
    torch.cuda.empty_cache()
    processes = serve_processes(args)
    shutil.rmtree(experiments.CACHE, ignore_errors=True)

    window_path = (f"serving window ({n_windows} windows); "
                   + "; ".join(f"{name} window ({len(GEO_CI)} windows)"
                               for name in multi_launches))
    paths = {k: window_path for k in launches}
    by_path = {k: {"serving window": launches[k],
                   **{name: c[k] for name, c in multi_launches.items()}}
               for k in launches}
    for k in launches:
        launches[k] = sum(by_path[k].values())
    paths.update({k: f"{arch} cells ({', '.join(ZOO_CALLS)})"
                  for arch, k in ZOO.items()})
    paths[BF16_FLASH] = (f"gemma2-2b bf16 serve path and cells "
                         f"({', '.join(LM_CALLS)}); "
                         + "; ".join(f"{a} cells ({', '.join(DENSE_CALLS)})"
                                     for a in DENSE_LMS) + "; "
                         + "; ".join(f"{a} cells ({', '.join(MOE_CALLS)})"
                                     for a in MOE_LMS))
    paths[F32_FLASH] = ("gemma2-2b f32 prefill(T) and prefill(T + 1) of "
                        "the serve path's identity check; "
                        + "; ".join(f"{a}'s f32 identity check"
                                    for a in DENSE_LMS + MOE_LMS))
    launches.update(zoo_launches)
    by_path.update({k: {f"{arch} cells": zoo_launches[k]}
                    for arch, k in ZOO.items()})
    launches[BF16_FLASH] = lm_launches + dense["bf16"] + moe["bf16"]
    launches[F32_FLASH] = f32_launches + dense["f32"] + moe["f32"]
    by_path[BF16_FLASH] = {"gemma2-2b": lm_launches,
                           "glm4-9b, minicpm-2b cells": dense["bf16"],
                           "granite-moe-1b-a400m, olmoe-1b-7b cells":
                               moe["bf16"]}
    by_path[F32_FLASH] = {"gemma2-2b identity": f32_launches,
                          "glm4-9b, minicpm-2b identity": dense["f32"],
                          "granite-moe-1b-a400m, olmoe-1b-7b identity":
                              moe["f32"]}
    results[BF16_FLASH]["dense_lm_heads"] = dense["heads"]
    results[BF16_FLASH]["moe_lm_heads"] = moe["heads"]
    # the training paths (phase 9): DIN's train_batch steps, the offline
    # experiment's training and scoring, the trained stack's windows
    train_counts = {
        "target_attention_bwd": {
            "din train_batch": din_train["target_attention_bwd"],
            "offline experiment": experiment["target_attention_bwd"]},
        "embedding_bag_bwd": {
            "offline experiment": experiment["embedding_bag_bwd"]},
        "target_attention": {
            "din train_batch": din_train["target_attention"],
            "offline experiment": experiment["target_attention"]},
        "embedding_bag": {
            "offline experiment": experiment["embedding_bag"]}}
    for k in WINDOW_KERNELS:
        train_counts.setdefault(k, {})["trained stack windows"] = \
            experiment["served"][k]
    # phase 9c: the zoo's train cells
    for arch, counts in zoo_train.items():
        for k, c in counts.items():
            train_counts.setdefault(k, {})[
                f"{arch} {ZOO_TRAIN[arch][0]}"] = c
    # the CLI's trained stack (its training in phase 4c) and phase 10
    for k, c in trained_build.items():
        train_counts.setdefault(k, {})["CLI trained stack training"] = c
    for k, c in cli.items():
        train_counts.setdefault(k, {})["trained CLI (phase 10)"] = c
    # phase 11's member processes, each counting its own launches
    for k, c in processes.items():
        train_counts.setdefault(k, {})["multi-process serving (phase 11)"] = c
    for k, counts in train_counts.items():
        by_path.setdefault(k, {}).update(counts)
        launches[k] = sum(by_path[k].values())
        paths[k] = "; ".join([p for p in (paths.get(k),) if p]
                             + list(counts))
    tpu = "src/repro/kernels/{}"
    replaces = {"cascade_truncate": tpu.format("cascade_truncate.py:34"),
                "target_attention": tpu.format("target_attention.py:46"),
                "embedding_bag": tpu.format("embedding_bag.py:24"),
                "dot_interact": tpu.format("dot_interact.py:34"),
                "cin_layer": tpu.format("cin.py:34"),
                "flash_attention": tpu.format("flash_attention.py:94"),
                "flash_attention_wgmma": tpu.format("flash_attention.py:94"),
                "target_attention_bwd": "src/repro/models/recsys/din.py:65 "
                                        "attention_pool (jax.grad)",
                "embedding_bag_bwd": "src/repro/models/embedding.py:58 "
                                     "fixed_bag (jax.grad)",
                "dot_interact_bwd": "src/repro/models/recsys/dlrm.py:99 "
                                    "dot_interact (jax.grad)",
                "cin_layer_bwd": "src/repro/models/recsys/xdeepfm.py:79 "
                                 "cin_layer (jax.grad)",
                "flash_attention_bwd": "src/repro/models/lm.py:296 "
                                       "_attention (jax.grad)"}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{build.KERNELS[name]}",
         "replaces": replaces[name], "launches": int(launches[name]),
         "path": paths[name],
         **({"launches_by_path": by_path[name]} if name in by_path else {}),
         "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "shape": r["shape"],
         **({"device_ms": r["device_ms"]} if "device_ms" in r else {}),
         **({"at_32k": r["at_32k"]} if "at_32k" in r else {}),
         **({"dense_lm_heads": r["dense_lm_heads"]}
            if "dense_lm_heads" in r else {}),
         **({"moe_lm_heads": r["moe_lm_heads"]}
            if "moe_lm_heads" in r else {}),
         **({"f32": r["f32"]} if "f32" in r else {})}
        for name, r in results.items()]}
    log(f"smoke wall {time.perf_counter() - t_smoke:.1f}s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
