"""The port's zero-stall streaming machinery against the JAX package's.

The prefetch thread, the slab-keyed table cache, the chunk-scorer pool,
the per-bucket window programs and their capture counting, on the CPU
at the small world of ``tests/test_torch_e2e.py`` (bridged weights).
Each test mirrors one of ``tests/test_zero_stall.py``,
``tests/test_request_source.py`` or ``tests/test_obs.py`` and runs the
JAX package beside the port where the JAX side exists.  On the CPU the
window and scoring programs run eagerly through the same static buffers
the card's CUDA graphs replay over, so the buffer, copy-out and
counting logic is exercised here; ``tests/test_torch_gpu.py`` holds the
captured graphs against the eager programs on the card.

Every equality here is bitwise: a window is a pure function of (seed,
t), and neither the thread, the cache nor the pool changes any
arithmetic.  Against the JAX package at raw inputs the decisions agree
on >= 99.5 % and the price within 1e-3 relative (f32 scores and sums in
another order), as in ``tests/test_torch_e2e.py``; fed the JAX tables and
rewards at a pinned price they are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.cascade import engine as jeng
from repro.core import action_chain as jac
from repro.core import reward_model as jrm
from repro.data import request_source as jrs
from repro.data.synthetic import StreamingWorld as JWorld
from repro.data.synthetic import WorldConfig as JWorldConfig
from repro.models.recsys import dien as jdien
from repro.models.recsys import din as jdin
from repro.models.recsys import dssm as jdssm
from repro.models.recsys import ydnn as jydnn
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.stream import run_stream as jrun_stream
from repro_torch import bridge
from repro_torch.cascade import engine as teng
from repro_torch.core import action_chain as tac
from repro_torch.core import primal_dual as tpd
from repro_torch.core import reward_model as trm
from repro_torch.data import request_source as trs
from repro_torch.data.synthetic import StreamingWorld as TWorld
from repro_torch.data.synthetic import WorldConfig as TWorldConfig
from repro_torch.models.recsys import dien, din, dssm, ydnn
from repro_torch.serving.pipeline import ServingPipeline as TPipeline
from repro_torch.serving.stream import run_stream as trun_stream

SIZES = [48, 64, 40]
EXPOSE = 6
SEED = 5
CHUNK = 64
WORLD = dict(n_users=5000, n_items=120, hist_len=8, n_cats=10, seed=3)
FLOPS = (2.0, 16.0, 512.0, 1024.0)  # DSSM, YDNN, DIN, DIEN per item


def _chains(ac):
    return ac.generate_action_chains((
        ac.StageSpec("recall", (ac.ModelInstance("DSSM", FLOPS[0]),),
                     (120,), 4),
        ac.StageSpec("prerank", (ac.ModelInstance("YDNN", FLOPS[1]),),
                     (24, 36, 48, 60), 4),
        ac.StageSpec("rank", (ac.ModelInstance("DIN", FLOPS[2]),
                              ac.ModelInstance("DIEN", FLOPS[3])),
                     (6, 12, 18, 24), 4)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks():
    wj = JWorldConfig(**WORLD)
    n_uf, ufv = wj.n_user_fields, wj.user_field_vocab
    voc = dict(item_vocab=wj.n_items, user_vocab=n_uf * ufv)
    rank = dict(voc, cat_vocab=wj.n_cats, n_user_fields=n_uf, embed_dim=4,
                seq_len=wj.hist_len, attn_hidden=(8, 4), mlp_hidden=(8, 4))
    cfgs = {
        "dssm": dict(voc, n_user_fields=n_uf, n_item_fields=1, embed_dim=4,
                     hidden=(16, 8), d_out=4),
        "ydnn": dict(voc, n_user_fields=n_uf, hist_len=wj.hist_len,
                     embed_dim=8, hidden=(16, 8), d_out=6),
        "din": rank, "dien": rank,
    }
    key = jax.random.PRNGKey(11)
    jmods, tmods = {}, {}
    for i, (name, jm, tm, jc, tc) in enumerate((
            ("dssm", jdssm, dssm, jdssm.DSSMConfig, dssm.DSSMConfig),
            ("ydnn", jydnn, ydnn, jydnn.YDNNConfig, ydnn.YDNNConfig),
            ("din", jdin, din, jdin.DINConfig, din.DINConfig),
            ("dien", jdien, dien, jdien.DIENConfig, dien.DIENConfig))):
        jcfg, tcfg = jc(**cfgs[name]), tc(**cfgs[name])
        jp = jax.jit(lambda k: jm.init(k, jcfg))(jax.random.fold_in(key, i))
        like = tm.init(torch.Generator().manual_seed(0), tcfg)
        jmods[name] = (jp, jcfg)
        tmods[name] = (bridge.from_numpy_tree(_np(jp), like=like,
                                              device="cpu"), tcfg)
    jmodels = jeng.CascadeModels(*jmods["dssm"], *jmods["ydnn"],
                                 *jmods["din"], *jmods["dien"])
    tmodels = teng.CascadeModels(*tmods["dssm"], *tmods["ydnn"],
                                 *tmods["din"], *tmods["dien"])
    jchains, tchains = _chains(jac), _chains(tac)
    rkw = dict(n_stages=3, max_models=2, n_scale_groups=4,
               d_context=3 + n_uf + wj.d_latent, d_feature=16, d_hidden=16,
               d_state=8)
    jrp = _np(jax.jit(lambda k: jrm.reward_model_init(
        k, jrm.RewardModelConfig(**rkw)))(jax.random.fold_in(key, 9)))
    jrp["label_norm"] = np.random.default_rng(1).uniform(
        0.5, 2.0, jchains.n_chains).astype(np.float32)
    trp = bridge.from_numpy_tree(
        jrp, like=trm.reward_model_init(torch.Generator(),
                                        trm.RewardModelConfig(**rkw)),
        device="cpu")
    jworld, tworld = JWorld.build(wj), TWorld.build(TWorldConfig(**WORLD))

    def jsrc(**kw):
        kw.setdefault("workers", 1)
        return jrs.GeneratedSource(jworld, jmodels, jchains, expose=EXPOSE,
                                   seed=SEED, chunk=CHUNK, item_block=64,
                                   **kw)

    def tsrc(**kw):
        return trs.GeneratedSource(tworld, tmodels, tchains, expose=EXPOSE,
                                   seed=SEED, chunk=CHUNK, item_block=64,
                                   device="cpu", **kw)

    jrcfg, trcfg = jrm.RewardModelConfig(**rkw), trm.RewardModelConfig(**rkw)
    budget = 0.5 * float(jchains.costs.max()) * SIZES[0]

    def jpipe(src, **kw):
        return JPipeline(src.universe,
                         jax.tree_util.tree_map(jnp.asarray, jrp), jrcfg,
                         budget, **kw)

    def tpipe(src, **kw):
        return TPipeline(src.universe, trp, trcfg, budget, device="cpu",
                         **kw)

    return dict(jsrc=jsrc, tsrc=tsrc, jpipe=jpipe, tpipe=tpipe, jrp=jrp,
                jrcfg=jrcfg, trp=trp, trcfg=trcfg, jchains=jchains,
                budget=budget)


def _assert_windows_equal(a, b, tag=""):
    for t, (x, y) in enumerate(zip(a.windows, b.windows)):
        np.testing.assert_array_equal(x.valid, y.valid, err_msg=f"{tag}{t}")
        for name in ("decisions", "revenue", "spend", "downgraded", "flops",
                     "lam_before", "lam_after"):
            assert torch.equal(getattr(x, name), getattr(y, name)), \
                f"{tag} window {t} {name}"


# ---------------------------------------------------------------------------
# Prefetch: determinism, exceptions, timing fields, injected clock
# ---------------------------------------------------------------------------


def test_prefetch_bitwise_sequential_and_rerun(stacks):
    """prefetch=2 serves the same windows as prefetch=0, bit for bit,
    and a rerun replays them; beside the JAX package's prefetched
    stream the decisions and prices agree as from raw inputs."""
    s = stacks
    runs = []
    for prefetch in (2, 0, 2):
        src = s["tsrc"]()
        runs.append(trun_stream(s["tpipe"](src), SIZES, src,
                                prefetch=prefetch))
    _assert_windows_equal(runs[0], runs[1], "prefetch 2 vs 0")
    _assert_windows_equal(runs[0], runs[2], "rerun")
    jsrc = s["jsrc"]()
    jst = jrun_stream(s["jpipe"](jsrc), SIZES, jsrc, prefetch=2)
    agree = sum(int((t.decisions_np == j.decisions_np).sum())
                for t, j in zip(runs[0].windows, jst.windows))
    assert agree / sum(SIZES) >= 0.995
    for t, j in zip(runs[0].windows, jst.windows):
        np.testing.assert_allclose(float(t.lam_after), float(j.lam_after),
                                   rtol=1e-3)


class _Boom(RuntimeError):
    pass


class _Failing:
    def __init__(self, src):
        self.src = src

    def window(self, t, n):
        if t == 1:
            raise _Boom("window 1 failed")
        return self.src.window(t, n)


def test_prefetch_producer_exception_surfaces(stacks):
    s = stacks
    src = s["tsrc"]()
    with pytest.raises(_Boom, match="window 1"):
        trun_stream(s["tpipe"](src), [16, 16, 16], _Failing(src),
                    prefetch=2)
    jsrc = s["jsrc"]()
    with pytest.raises(_Boom, match="window 1"):
        jrun_stream(s["jpipe"](jsrc), [16, 16, 16], _Failing(jsrc),
                    prefetch=2)


def test_stream_stats_timing_fields(stacks):
    """dispatch_ms == prep + submit per window, stalls and host->device
    bytes recorded; the sequential path never stalls."""
    s = stacks
    src = s["tsrc"]()
    st = trun_stream(s["tpipe"](src), SIZES, src, prefetch=2)
    assert len(st.prep_ms) == len(st.submit_ms) == len(SIZES)
    np.testing.assert_allclose(
        st.dispatch_ms, [p + q for p, q in zip(st.prep_ms, st.submit_ms)])
    assert all(x >= 0.0 for x in st.stall_ms)
    assert st.h2d_bytes > 0
    src0 = s["tsrc"]()
    st0 = trun_stream(s["tpipe"](src0), SIZES, src0, prefetch=0)
    assert st0.stall_ms == [0.0] * len(SIZES)
    assert st0.h2d_bytes == st.h2d_bytes


class _FakeResult:
    def __init__(self):
        self.prep_ms = 0.0
        self.stall_ms = 0.0
        self.h2d_bytes = 0
        self.compiles = 0
        self.bucket = None
        self.n_valid = 0
        self.revenue_np = np.zeros(0, np.float32)


class _FakePipeline:
    device = torch.device("cpu")

    def serve_window(self, ctx, rows, **kw):
        return _FakeResult()


class _FakeSource:
    def window(self, t, n):
        return trs.WindowChunk(ctx=np.zeros((n, 2), np.float32),
                               rows=np.zeros(n, np.int32), tables={})


def test_fake_clock_timing_attribution():
    """With an injected clock the sequential driver's attribution is
    exact, tick for tick the JAX driver's: t0 | prep0 | serve0 prep1 |
    serve1 prep2 | serve2 | wall, each phase one 1 s tick."""
    stats = []
    for run in (trun_stream, jrun_stream):
        ticks = iter(range(1000))
        stats.append(run(_FakePipeline(), [4, 4, 4], _FakeSource(),
                         prefetch=0, clock=lambda: float(next(ticks))))
    st, jst = stats
    assert st.prep_ms == [1000.0, 1000.0, 1000.0]
    assert st.submit_ms == [1000.0, 1000.0, 1000.0]
    assert st.stall_ms == [0.0, 0.0, 0.0]
    assert st.dispatch_ms == [2000.0, 2000.0, 2000.0]
    assert st.wall_s == 13.0
    for name in ("prep_ms", "submit_ms", "stall_ms", "dispatch_ms",
                 "wall_s"):
        assert getattr(st, name) == getattr(jst, name), name


# ---------------------------------------------------------------------------
# Slab-keyed table cache and the chunk-scorer pool
# ---------------------------------------------------------------------------


def test_table_cache_hits_are_bitwise(stacks):
    """A replayed window hits the cache (no rescoring) and returns the
    same tables bit for bit; a cold source recomputes them equal.  The
    counters move as the JAX source's do."""
    s = stacks
    src, jsrc = s["tsrc"](), s["jsrc"]()
    a = src.window(4, 100)
    jsrc.window(4, 100)
    misses = src.cache_misses
    assert misses == 2 and src.cache_hits == 0  # chunks of 64 and 36
    b = src.window(4, 100)
    jsrc.window(4, 100)
    assert src.cache_hits == 2 and src.cache_misses == misses
    assert (src.cache_hits, src.cache_misses) == (jsrc.cache_hits,
                                                  jsrc.cache_misses)
    np.testing.assert_array_equal(a.ctx, b.ctx)
    for k in ("p", "ck"):
        assert torch.equal(a.tables[k], b.tables[k]), k
    c = s["tsrc"]().window(4, 100)
    for k in ("p", "ck"):
        assert torch.equal(a.tables[k], c.tables[k]), k


def test_table_cache_lru_eviction(stacks):
    s = stacks
    src, jsrc = s["tsrc"](table_cache=2), s["jsrc"](table_cache=2)
    for t in (0, 1, 2):  # window 2 evicts window 0's slab
        src.window(t, 64)
        jsrc.window(t, 64)
    assert len(src._cache) == len(jsrc._cache) == 2
    misses = src.cache_misses
    src.window(1, 64)  # still cached
    assert src.cache_misses == misses and src.cache_hits == 1
    src.window(0, 64)  # cold again
    jsrc.window(1, 64)
    jsrc.window(0, 64)
    assert src.cache_misses == misses + 1
    assert (src.cache_hits, src.cache_misses) == (jsrc.cache_hits,
                                                  jsrc.cache_misses)


def test_chunk_scorer_pool_bitwise(stacks):
    """workers=3 scores a three-chunk window on the thread pool, each
    chunk on its own scoring program, bitwise the one-worker window."""
    s = stacks
    one, three = s["tsrc"](), s["tsrc"](workers=3)
    assert len(three.programs) == 3
    a, b = one.window(2, 170), three.window(2, 170)  # chunks 64, 64, 42
    assert three._pool is not None and three.cache_misses == 3
    three.close()
    np.testing.assert_array_equal(a.ctx, b.ctx)
    for k in ("p", "ck"):
        assert torch.equal(a.tables[k], b.tables[k]), k


# ---------------------------------------------------------------------------
# Window programs: capture counting, aliasing, parity with JAX
# ---------------------------------------------------------------------------


def test_spike_stream_zero_steady_compiles(stacks):
    """A 10x swing in pow2 buckets: every bucket builds its program
    once, on first sight, where the JAX pipeline compiles; warm buckets
    build nothing."""
    s = stacks
    b = 32
    sizes = [b, 10 * b, b, 10 * b, b, 10 * b]
    src, jsrc = s["tsrc"](workers=2), s["jsrc"](workers=2)
    pipe = s["tpipe"](src, bucketing="pow2")
    st = trun_stream(pipe, sizes, src, prefetch=2)
    src.close()
    jst = jrun_stream(s["jpipe"](jsrc, bucketing="pow2"), sizes, jsrc,
                      prefetch=2)
    assert st.steady_compiles == 0 and jst.steady_compiles == 0
    assert st.compiles[2] == st.compiles[3] == st.compiles[4] == 0
    assert st.compiles[:2] == [2, 2]  # the main pass and the dual loop
    assert [c > 0 for c in st.compiles] == [c > 0 for c in jst.compiles]
    assert pipe.compile_count() == 4 and len(pipe._programs) == 2
    assert [w.bucket for w in st.windows[:2]] == [(32, False), (512, True)]
    assert st.total_revenue > 0


def test_records_stay_distinct_across_replays(stacks):
    """Two windows of one bucket: the first window's record still reads
    what it read when served, though the program's static outputs now
    hold the second window's."""
    s = stacks
    src = s["tsrc"]()
    pipe = s["tpipe"](src)
    names = ("decisions", "revenue", "spend", "downgraded", "flops",
             "lam_before", "lam_after")
    recs, snaps = [], []
    for t, n in enumerate((60, 50)):  # both in the 64 bucket, padded
        c = src.window(t, n)
        r = pipe.serve_window(c.ctx, c.rows, tables=c.tables, lam=2e-4 * t,
                              ready=c.ready)
        recs.append(r)
        snaps.append({k: getattr(r, k).clone() for k in names})
    assert recs[0].bucket == recs[1].bucket == (64, True)
    assert recs[1].compiles == 0 and len(pipe._programs) == 1
    for r, snap in zip(recs, snaps):
        for k in names:
            assert torch.equal(getattr(r, k), snap[k]), k
    assert not torch.equal(recs[0].lam_before, recs[1].lam_before)
    assert not torch.equal(recs[0].revenue[:50], recs[1].revenue[:50])
    prog = pipe._programs[(64, True)]
    assert recs[1].decisions.data_ptr() != prog.main.out["dec"].data_ptr()


class _FedRewards(TPipeline):
    """The port's pipeline fed a given reward matrix per window."""

    def _rewards(self, ctx):
        return self.fed.pop(0)


class _JaxChunks:
    """The JAX source's chunks, as the port's (torch tables)."""

    def __init__(self, jsrc):
        self.jsrc = jsrc

    def window(self, t, n):
        c = self.jsrc.window(t, n)
        return trs.WindowChunk(
            ctx=c.ctx, rows=c.rows,
            tables={k: torch.tensor(np.asarray(v))
                    for k, v in c.tables.items()}, h2d_bytes=c.h2d_bytes)


def test_pinned_prefetched_stream_exact(stacks):
    """The port's prefetched stream, fed the JAX chunk tables and the
    JAX reward matrices at a pinned price per window, serves exactly the
    JAX prefetched stream's decisions, revenue, spend, FLOPs and
    downgrades."""
    s = stacks
    lam_trace = [0.0, 5e-5, 2e-4]
    jsrc = s["jsrc"]()
    jst = jrun_stream(s["jpipe"](jsrc), SIZES, jsrc, lam_trace=lam_trace,
                      prefetch=2)
    plan = jrm.chain_prefix_plan(s["jchains"].chain_idx[:, :, 0])
    sh = jnp.asarray(s["jchains"].scale_multihot)
    jp = jax.tree_util.tree_map(jnp.asarray, s["jrp"])
    reward_fn = jax.jit(lambda p, c: jrm.denormalize_rewards(
        p, jrm.reward_matrix_grouped(p, s["jrcfg"], c, sh, plan)))
    fed = []
    for t, (n, jw) in enumerate(zip(SIZES, jst.windows)):
        ctx = np.zeros((len(jw.valid), s["jrcfg"].d_context), np.float32)
        ctx[:n] = jsrc.window(t, n).ctx
        fed.append(torch.tensor(np.asarray(reward_fn(jp, jnp.asarray(ctx)))))
    pipe = _FedRewards(s["tsrc"]().universe, s["trp"], s["trcfg"],
                       s["budget"], device="cpu")
    pipe.fed = fed
    tst = trun_stream(pipe, SIZES, _JaxChunks(jsrc), lam_trace=lam_trace,
                      prefetch=2)
    assert not pipe.fed
    downgraded = 0
    for tw, jw in zip(tst.windows, jst.windows):
        np.testing.assert_array_equal(tw.valid, jw.valid)
        np.testing.assert_array_equal(tw.decisions_np, jw.decisions_np)
        np.testing.assert_array_equal(tw.revenue_np, jw.revenue_np)
        assert float(tw.spend) == float(jw.spend)
        assert float(tw.flops) == float(jw.flops)
        assert int(tw.downgraded) == int(jw.downgraded)
        downgraded += int(tw.downgraded)
    assert downgraded > 0  # the pinned zero price made the guard act


# ---------------------------------------------------------------------------
# Nothing captured synchronises
# ---------------------------------------------------------------------------

# ops that read a device value on the host (or branch on it) and so
# synchronise with the card
_SYNCING = {"_local_scalar_dense", "item", "nonzero", "is_nonzero", "equal"}


class _SyncWatch(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.syncing: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func.overloadpacket.__name__ in _SYNCING:
            self.syncing.append(str(func))
        return func(*args, **(kwargs or {}))


def test_captured_functions_never_synchronise(stacks):
    """The functions the card captures - the window program's main pass
    and dual loop, ``dual_descent`` itself, and each scoring program
    (four stage models and the table compaction) - run no op that
    would make the host wait for the device."""
    s = stacks
    src = s["tsrc"]()
    pipe = s["tpipe"](src)
    for t, n in enumerate((48, 64)):  # a padded and an unpadded bucket
        c = src.window(t, n)
        pipe.serve_window(c.ctx, c.rows, tables=c.tables, ready=c.ready)
    scorer = src.programs[0]
    fns = {f"window {key} {name}": getattr(prog, name).fn
           for key, prog in pipe._programs.items()
           for name in ("main", "dual")}
    fns.update({f"score {name}": prog.fn
                for name, prog in scorer.models.items()})
    fns["tables/compact"] = scorer.tables.fn
    wp = pipe._programs[(64, True)]
    fns["dual_descent"] = lambda: tpd.dual_descent(
        wp.rewards, pipe._costs, pipe.budget, 1e-4, mask=wp.valid)
    for name, fn in fns.items():
        with _SyncWatch() as watch:
            fn()
        assert watch.ops > 10, name  # the mode saw the function's ops
        assert not watch.syncing, (name, watch.syncing)
