"""The training substrate: the port against the JAX package on the CPU.

Optimizers, schedules and clipping on the same numpy trees and gradients
(1e-6); the train step on DIN's and DIEN's smoke widths from JAX's init
carried over by ``bridge.from_numpy_tree``, on the same batches, with 1
and 2 microbatches (1e-5: f32 sums in another order, through three
optimizer steps); the pipeline bit for bit; the trainer's preemption and
resume; the training CLI and DIN's ``train_batch`` cell at the smoke
widths (the CPU cannot draw ``full_config()``'s 10M-row table in the
tests' time; the full width runs on the card in ``chip_smoke.py`` phase
9a).
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din_arch as jdin_arch
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import layers as jL
from repro.models.recsys import dien as jdien
from repro.models.recsys import din as jdin
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import din_arch, get_arch
from repro_torch.data import pipeline as pipe
from repro_torch.data import synthetic as syn
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models.recsys import dien, din
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                          build_train_step, init_state,
                                          value_and_grad)
from repro_torch.tree import leaves, leaves_with_paths

TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree(rng, scale=1.0):
    f = np.float32
    return {"b": {"w": (rng.normal(size=(3, 4)) * scale).astype(f),
                  "bias": (rng.normal(size=4) * scale).astype(f)},
            "a": [{"w": (rng.normal(size=(2, 2)) * scale).astype(f)},
                  {"w": (rng.normal(size=5) * scale).astype(f)}],
            "c": (rng.normal(size=3) * scale).astype(f)}


def _assert_tree_close(port, jax_tree, tol):
    got = leaves_with_paths(port)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_tree)[0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=key)


def _as_torch(tree):
    return bridge.from_numpy_tree(tree, device="cpu")


@pytest.mark.parametrize("make", [
    lambda m: (opt.AdamW(weight_decay=0.01), jopt.AdamW(weight_decay=0.01)),
    lambda m: (opt.AdamW(b1=0.8, b2=0.99, eps=1e-6),
               jopt.AdamW(b1=0.8, b2=0.99, eps=1e-6)),
    lambda m: (opt.SGD(momentum=0.9), jopt.SGD(momentum=0.9)),
    lambda m: (opt.SGD(momentum=0.5, nesterov=True),
               jopt.SGD(momentum=0.5, nesterov=True)),
])
def test_optimizers_match_jax(make):
    port, ref = make(None)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    p_params, j_params = _as_torch(params), jax.tree_util.tree_map(
        jnp.asarray, params)
    p_state, j_state = port.init(p_params), ref.init(j_params)
    sched_p = opt.cosine_schedule(1e-2, 2, 6)
    sched_j = jopt.cosine_schedule(1e-2, 2, 6)
    for step in range(5):
        grads = _tree(rng, scale=0.1)
        p_params, p_state = port.update(_as_torch(grads), p_state, p_params,
                                        sched_p(torch.tensor(step)))
        j_params, j_state = ref.update(
            jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params,
            sched_j(jnp.int32(step)))
    _assert_tree_close(p_params, j_params, TOL)
    _assert_tree_close(p_state, j_state, TOL)
    assert int(p_state.step) == int(j_state.step) == 5


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    p_clip, p_norm = opt.clip_by_global_norm(_as_torch(g), max_norm)
    j_clip, j_norm = jopt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    np.testing.assert_allclose(float(p_norm), float(j_norm), **TOL)
    _assert_tree_close(p_clip, j_clip, TOL)
    assert float(L.global_norm(_as_torch(g))) == pytest.approx(
        float(jL.global_norm(g)), rel=1e-6)
    assert L.count_params(_as_torch(g)) == jL.count_params(g)
    assert L.param_bytes(_as_torch(g)) == jL.param_bytes(g)


@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", (1e-3, 10, 40, 1e-5)),
    ("cosine_schedule", (1.0, 0, 7)),
    ("wsd_schedule", (1e-3, 5, 20, 10)),
    ("constant_schedule", (3e-4,)),
])
def test_schedules_match_jax(name, args):
    """f32 arithmetic in JAX's order; the cosine's last ulp may differ
    (XLA's cos against torch's)."""
    p, j = getattr(opt, name)(*args), getattr(jopt, name)(*args)
    for step in range(0, 60):
        got = p(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j(jnp.int32(step))),
                                   **TOL, err_msg=str(step))
    if name == "cosine_schedule" and args[1]:
        assert float(p(0)) == 0.0  # the first update moves only moments


def test_tree_order_is_jax_order():
    """Sorted dict keys, list indices, NamedTuple fields as ``.name``, the
    TrainState's fields as indices: JAX's checkpoint path keys."""
    params = _tree(np.random.default_rng(2))
    p_state = init_state(_as_torch(params), opt.AdamW())
    j_state = jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                                  jopt.AdamW())
    _assert_tree_close(p_state, j_state, dict(rtol=0, atol=0))
    keys = [k for k, _ in leaves_with_paths(p_state)]
    assert keys[0] == "0" and keys[1] == "1/a/0/w"
    assert "2/.step" in keys and keys[-1] == "2/.nu/c"


def _din_smoke():
    cfg = jdin_arch.smoke_config()
    pcfg = din_arch.smoke_config()
    assert vars(cfg) == vars(pcfg)
    jparams = jdin.init(jax.random.PRNGKey(0), cfg)
    pparams = bridge.from_numpy_tree(
        _np(jparams), like=din.init(torch.Generator().manual_seed(0), pcfg),
        device="cpu")
    return (jparams, lambda p, b: jdin.loss_fn(p, cfg, b),
            pparams, lambda p, b: din.loss_fn(p, pcfg, b))


def _dien_smoke():
    kw = dict(item_vocab=500, cat_vocab=20, user_vocab=200,
              n_user_fields=2, embed_dim=8, seq_len=12, attn_hidden=(16, 8),
              mlp_hidden=(32, 16))
    cfg, pcfg = jdien.DIENConfig(**kw), dien.DIENConfig(**kw)
    jparams = jdien.init(jax.random.PRNGKey(1), cfg)
    pparams = bridge.from_numpy_tree(
        _np(jparams), like=dien.init(torch.Generator().manual_seed(0), pcfg),
        device="cpu")
    return (jparams, lambda p, b: jdien.loss_fn(p, cfg, b),
            pparams, lambda p, b: dien.loss_fn(p, pcfg, b))


# DIEN's step runs SGD: its last attention bias has an exactly-zero
# gradient (a softmax does not see a shift), which AdamW's first step
# divides by its own magnitude, so the packages' f32 rounding noise in
# that gradient (about 1e-9) would move the bias by up to lr; SGD keeps
# the difference at the noise's size.  The optimizers themselves are
# held to JAX on the same gradients above.
OPTIMIZERS = {"din": ("AdamW", dict(weight_decay=0.01)),
              "dien": ("SGD", dict(momentum=0.9))}


@pytest.mark.parametrize("model", ["din", "dien"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(model, n_micro):
    """Three steps of ``build_train_step`` (cosine with warmup, clip 1.0)
    from JAX's init on the same smoke batches."""
    jparams, jloss, pparams, ploss = {"din": _din_smoke,
                                      "dien": _dien_smoke}[model]()
    name, okw = OPTIMIZERS[model]
    kw = dict(n_microbatches=n_micro, clip_norm=1.0)
    jstep = jtrainer.build_train_step(
        jloss, getattr(jopt, name)(**okw), jopt.cosine_schedule(1e-2, 1, 3),
        donate=False, **kw)
    pstep = build_train_step(ploss, getattr(opt, name)(**okw),
                             opt.cosine_schedule(1e-2, 1, 3), **kw)
    j_state = jtrainer.init_state(jparams, getattr(jopt, name)(**okw))
    p_state = init_state(pparams, getattr(opt, name)(**okw))
    rng = np.random.default_rng(7)
    cfg = din_arch.smoke_config()
    for _ in range(3):
        b = {k: v.numpy() for k, v in din_arch.smoke_batch(rng, cfg).items()}
        b["hist_mask"][::3, 5:] = 0.0  # some short histories
        j_state, jm = jstep(j_state, jax.tree_util.tree_map(jnp.asarray, b))
        p_state, pm = pstep(p_state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       **STEP_TOL)
    _assert_tree_close(p_state.params, j_state.params, STEP_TOL)
    _assert_tree_close(p_state.opt_state, j_state.opt_state, STEP_TOL)
    assert not any(p.requires_grad for p in leaves(p_state.params))


def test_unused_leaves_get_zero_gradients():
    params = {"used": torch.ones(3), "unused": torch.ones(2)}
    loss, grads = value_and_grad(lambda p, b: (p["used"] * b).sum(), params,
                                 torch.arange(3.0))
    assert float(loss) == 3.0
    assert torch.equal(grads["unused"], torch.zeros(2))
    assert torch.equal(grads["used"], torch.arange(3.0))


# -- the pipeline -----------------------------------------------------------


def _ctr_fns():
    jw = jsyn.build_world(jsyn.WorldConfig(n_users=120, n_items=50,
                                           hist_len=6, seed=2))
    pw = syn.build_world(syn.WorldConfig(n_users=120, n_items=50,
                                         hist_len=6, seed=2))
    users = np.arange(0, 120, 3)
    return (jpipe.recsys_ctr_batch_fn(jw, users),
            pipe.recsys_ctr_batch_fn(pw, users))


@pytest.mark.parametrize("which", ["lm", "ctr"])
def test_pipeline_batches_bit_equal_jax(which):
    jfn, pfn = ((jpipe.lm_token_batch_fn(97, 9), pipe.lm_token_batch_fn(97,
                                                                        9))
                if which == "lm" else _ctr_fns())
    for host in range(2):
        shard = dict(host_id=host, n_hosts=2)
        jp = jpipe.DeterministicPipeline(jfn, 8, seed=5,
                                         shard=jpipe.ShardInfo(**shard))
        pp = pipe.DeterministicPipeline(pfn, 8, seed=5,
                                        shard=pipe.ShardInfo(**shard))
        jp.seek(3)
        pp.seek(3)
        for _ in range(3):
            a, b = jp.next(), pp.next()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        pipe.DeterministicPipeline(pfn, 7, shard=pipe.ShardInfo(0, 2))


def test_prefetcher_yields_in_order_and_closes():
    out = [b["i"] for b in pipe.Prefetcher(iter([{"i": i}
                                                 for i in range(5)]),
                                           depth=2)]
    assert out == [0, 1, 2, 3, 4]
    pf = pipe.Prefetcher(iter(range(100)), depth=2)
    assert next(pf) == 0
    pf.close()


# -- the trainer ------------------------------------------------------------


def _quad_pipeline():
    w_true = np.asarray([[1.0, -2.0], [0.5, 3.0]])

    def fn(rng, step, lo, hi):
        x = rng.normal(size=(2, hi - lo)).astype(np.float32)
        return {"x": x, "y": (w_true @ x).astype(np.float32)}

    return pipe.DeterministicPipeline(fn, 32, seed=1)


def _quad_loss(params, batch):
    return torch.mean(torch.square(params["w"] @ batch["x"] - batch["y"]))


def _trainer(tmp_path, total):
    o = opt.AdamW()
    step = build_train_step(_quad_loss, o, lambda s: 0.05)
    return Trainer(TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path),
                                 ckpt_every=4, keep_ckpts=2, log_every=5),
                   step, init_state({"w": torch.zeros(2, 2)}, o),
                   _quad_pipeline(), log_fn=lambda *a: None)


def test_trainer_preempts_and_resumes_to_the_same_state(tmp_path):
    """SIGTERM mid-run checkpoints and stops; a new trainer resumes from
    the checkpoint (the pipeline seeks to its step) and ends bitwise where
    an uninterrupted run ends."""
    full = _trainer(tmp_path / "full", 20)
    full_out = full.run()

    part = _trainer(tmp_path / "part", 20)
    old = signal.getsignal(signal.SIGTERM)
    try:
        part.install_preemption_handler()
        calls = {"n": 0}
        inner = part.train_step

        def step_then_term(state, batch):
            calls["n"] += 1
            if calls["n"] == 7:
                os.kill(os.getpid(), signal.SIGTERM)
            return inner(state, batch)

        part.train_step = step_then_term
        part.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ck.latest_step(str(tmp_path / "part")) == 7
    assert int(part.state.step) == 7

    resumed = _trainer(tmp_path / "part", 20)
    resumed.maybe_resume()
    assert int(resumed.state.step) == 7 and resumed.pipeline.step == 7
    out = resumed.run()
    assert torch.equal(resumed.state.params["w"], full.state.params["w"])
    assert ck.latest_step(str(tmp_path / "part")) == 20
    assert len([d for d in os.listdir(tmp_path / "part")
                if d.startswith("step_")]) == 2  # keep_ckpts
    assert out["final"] == full_out["final"]
    assert out["final"]["step"] == 20


def test_adamw_solves_quadratic():
    o = opt.AdamW()
    step = build_train_step(_quad_loss, o, lambda s: 0.05)
    state = init_state({"w": torch.zeros(2, 2)}, o)
    p = _quad_pipeline()
    for _ in range(300):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in p.next().items()})
    assert float(m["loss"]) < 1e-2


# -- the CLI and DIN's train cell -------------------------------------------


def test_train_cli_trains_din_smoke_and_resumes(tmp_path, capsys):
    args = ["--arch", "din", "--preset", "smoke", "--device", "cpu",
            "--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    assert train_cli.main(args) == 0
    out = capsys.readouterr().out
    assert "final_loss=" in out and "nan" not in out
    assert ck.latest_step(str(tmp_path)) == 6
    assert train_cli.main(args[:-4] + ["--steps", "8", "--ckpt-dir",
                                       str(tmp_path), "--resume"]) == 0
    assert "resumed from step 6" in capsys.readouterr().out
    # dlrm-rm2 trains too (ROADMAP queue A item 25), and resumes
    dl = tmp_path / "dlrm"
    args = ["--arch", "dlrm-rm2", "--device", "cpu", "--steps", "4",
            "--ckpt-dir", str(dl), "--ckpt-every", "2"]
    assert train_cli.main(args) == 0
    out = capsys.readouterr().out
    assert "arch=dlrm-rm2" in out and "nan" not in out
    assert ck.latest_step(str(dl)) == 4
    assert train_cli.main(args[:4] + ["--steps", "6", "--ckpt-dir", str(dl),
                                      "--resume"]) == 0
    assert "resumed from step 4" in capsys.readouterr().out
    assert ck.latest_step(str(dl)) == 6


def test_din_train_cell_matches_jax_step_at_smoke_widths():
    """``make_cell("train_batch", smoke_config())``: the JAX cell's step
    (AdamW without weight decay, lr 1e-3, no clipping) from JAX's init,
    two steps on the cell's own batch."""
    assert get_arch("din") is din_arch
    cell = din_arch.make_cell("train_batch", din_arch.smoke_config())
    assert cell.kind == "train"
    cfg = jdin_arch.smoke_config()
    state, batch = cell.make_args(0, "cpu")
    assert batch["hist_ids"].shape == (65_536, cfg.seq_len)
    small = {k: v[:64] for k, v in batch.items()}  # 64 rows: CPU time
    jparams, jloss, pparams, _ = _din_smoke()
    state = init_state(pparams, opt.AdamW(weight_decay=0.0))
    jo = jopt.AdamW(weight_decay=0.0)
    j_state = jtrainer.init_state(jparams, jo)
    jb = {k: jnp.asarray(v.numpy()) for k, v in small.items()}
    for _ in range(2):
        state, loss = cell.fn(state, small)
        jl, g = jax.value_and_grad(lambda p: jloss(p, jb))(j_state.params)
        new_p, new_o = jo.update(g, j_state.opt_state, j_state.params, 1e-3)
        j_state = jtrainer.TrainState(j_state.step + 1, new_p, new_o)
        np.testing.assert_allclose(float(loss), float(jl), **STEP_TOL)
    _assert_tree_close(state.params, j_state.params, STEP_TOL)
    assert cell.meta["model_flops"] == pytest.approx(
        3 * 65_536 * din.flops_per_item(din_arch.smoke_config()))


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_din_serve_cells_at_smoke_widths(shape):
    """The serving cells: ``forward`` and ``score_candidates_chunked``
    against the JAX model on the same weights (retrieval at 1,024
    candidates: the cell's million is CPU time)."""
    cfg = din_arch.smoke_config()
    jparams, _, pparams, _ = _din_smoke()
    rng = np.random.default_rng(3)
    b = {k: v.numpy() for k, v in din_arch.smoke_batch(rng, cfg).items()}
    if shape == "serve_p99":
        cell = din_arch.make_cell(shape, cfg)
        params, batch = cell.make_args(0, "cpu")
        assert batch["hist_ids"].shape[0] == 512
        got = cell.fn(pparams, {k: torch.from_numpy(v) for k, v in b.items()})
        want = jdin.forward(jparams, jdin_arch.smoke_config(),
                            jax.tree_util.tree_map(jnp.asarray, b))
    else:
        user = {k: v[:1] for k, v in b.items()}
        cid = rng.integers(0, cfg.item_vocab, 1024).astype(np.int32)
        cc = rng.integers(0, cfg.cat_vocab, 1024).astype(np.int32)
        got = din.score_candidates_chunked(
            pparams, cfg, {k: torch.from_numpy(v) for k, v in user.items()},
            torch.from_numpy(cid), torch.from_numpy(cc))
        want = jdin.score_candidates_chunked(
            jparams, jdin_arch.smoke_config(),
            jax.tree_util.tree_map(jnp.asarray, user), jnp.asarray(cid),
            jnp.asarray(cc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
