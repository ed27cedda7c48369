"""BST, LayerNorm and the ragged embedding bag: the JAX package against
the port, on the CPU.

The same numpy inputs and the same weights (JAX's ``init`` carried over
by ``bridge.from_numpy_tree``) at the smoke widths:
* ``layernorm_apply`` (eps 1e-6, biased variance) within 1e-5;
* the ragged ``embedding_bag`` in sum, mean and max, with and without
  per-sample weights, empty bags (-inf under max, 0 otherwise) and
  segment ids outside [0, num_bags) (dropped), within 1e-5;
* BST's ``forward``, ``score``, ``score_candidates_chunked`` and
  ``loss_fn`` within 1e-5, and the loss's gradient within 5e-5 of each
  gradient's largest magnitude;
* the configs, FLOP counts, cells and their CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst_arch as jbst_cfg
from repro.models import embedding as jemb
from repro.models import layers as jlayers
from repro.models.recsys import bst as jbst
from repro_torch import bridge
from repro_torch.configs import bst_arch, get_arch
from repro_torch.models import embedding as temb
from repro_torch.models import layers as L
from repro_torch.models.recsys import bst
from repro_torch.training.trainer import value_and_grad
from torch_parity import F32_TOL, assert_grads_close, np_tree

# -- layernorm -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 16), (7, 64)])
def test_layernorm_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (3.0 * rng.normal(size=shape) + 1.5).astype(np.float32)
    p = {"scale": rng.normal(size=shape[-1]).astype(np.float32),
         "bias": rng.normal(size=shape[-1]).astype(np.float32)}
    want = jlayers.layernorm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x))
    got = L.layernorm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    init = L.layernorm_init(4)
    assert init["scale"].tolist() == [1.0] * 4
    assert init["bias"].tolist() == [0.0] * 4


def test_layernorm_eps_is_jax_not_torch():
    """A row of variance 1e-5: torch's default eps (1e-5) would halve it."""
    x = torch.tensor([[0.0, 2 * 10 ** -2.5]])
    got = L.layernorm_apply(L.layernorm_init(2), x)
    want = jlayers.layernorm_apply(jlayers.layernorm_init(2),
                                   jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- the ragged embedding bag ----------------------------------------------------


def _bag_case(v, n, bags, seed, *, weighted=False, outside=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, 4)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    seg = np.sort(rng.integers(0, bags, n)).astype(np.int32)
    if outside is not None:  # segment_sum drops ids outside [0, outside)
        seg[:2] = [-1, outside]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    return table, ids, seg, w


def _check_bag(table, ids, seg, bags, mode, w):
    want = np.asarray(jemb.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), bags,
        mode=mode, per_sample_weights=None if w is None else jnp.asarray(w)))
    got = temb.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(seg), bags, mode=mode,
        per_sample_weights=None if w is None else torch.from_numpy(w))
    assert got.shape == want.shape == (bags, table.shape[1])
    np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                  np.isneginf(want))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    return got


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("v,l", [(2, 1), (7, 3), (30, 8), (13, 5)])
def test_embedding_bag_matches_jax(mode, v, l):
    """tests/test_models_recsys.py's cases: 3 l ids in 3 sorted bags of
    a (v, 4) table; with l = 1 some bags are empty."""
    table, ids, seg, _ = _bag_case(v, 3 * l, 3, v * 31 + l)
    _check_bag(table, ids, seg, 3, mode, None)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_empty_weighted_and_outside(mode):
    """Bags 4..9 of 10 stay empty (-inf under max, 0 under sum and mean);
    per-sample weights scale each row; ids outside [0, 10) are dropped."""
    table, ids, seg, w = _bag_case(20, 12, 4, 5, weighted=True,
                                   outside=10)
    got = _check_bag(table, ids, seg, 10, mode, w)
    empty = got[4:]
    if mode == "max":
        assert torch.isneginf(empty).all()
    else:
        assert (empty == 0).all()


def test_embedding_bag_unsorted_segments_and_bad_mode():
    table, ids, seg, _ = _bag_case(9, 20, 5, 2)
    seg = np.random.default_rng(3).permutation(seg)
    for mode in ("sum", "mean", "max"):
        _check_bag(table, ids, seg, 5, mode, None)
    with pytest.raises(ValueError, match="mode"):
        temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(seg), 5, mode="median")


# -- BST on bridged weights ------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jbst_cfg.smoke_config(), bst_arch.smoke_config()
    jp = jbst.init(jax.random.PRNGKey(3), jcfg)
    like = bst.init(torch.Generator().manual_seed(0), cfg)
    tp = bridge.from_numpy_tree(np_tree(jp), like=like, device="cpu")
    rng = np.random.default_rng(7)
    batch = {k: v.numpy() for k, v in bst_arch.smoke_batch(rng, cfg).items()}
    # ragged histories: the mask and its -1e9 fill bite
    t = cfg.seq_len - 1
    batch["hist_mask"] = (np.arange(t)[None] < rng.integers(
        0, t + 1, (len(batch["label"]), 1))).astype(np.float32)
    return jcfg, cfg, jp, tp, batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_bridge_carries_the_tree(pair):
    _, cfg, jp, tp, _ = pair
    # 3 tables, pos_emb; a block: 4 projections, 2 norms, a 2-layer FFN;
    # the 4-layer head
    assert len(jax.tree_util.tree_leaves(jp)) == 4 + (4 + 2 * 2 + 2 * 2) + 8
    assert tp["blocks"][0]["ln1"]["bias"].shape == (cfg.d_item,)
    np.testing.assert_array_equal(tp["pos_emb"].numpy(),
                                  np.asarray(jp["pos_emb"]))


def test_forward_matches_jax(pair):
    jcfg, cfg, jp, tp, batch = pair
    want = np.asarray(jbst.forward(jp, jcfg, _j(batch)))
    got = bst.forward(tp, cfg, _t(batch))
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_score_matches_jax(pair):
    jcfg, cfg, jp, tp, batch = pair
    rng = np.random.default_rng(11)
    b = 4
    user = {k: v[:b] for k, v in batch.items()
            if k not in ("item_id", "item_cat", "label")}
    cid = rng.integers(0, cfg.item_vocab, (b, 5)).astype(np.int32)
    ccat = rng.integers(0, cfg.cat_vocab, (b, 5)).astype(np.int32)
    want = np.asarray(jbst.score(jp, jcfg, _j(user), jnp.asarray(cid),
                                 jnp.asarray(ccat)))
    got = bst.score(tp, cfg, _t(user), torch.from_numpy(cid),
                    torch.from_numpy(ccat))
    assert got.shape == (b, 5)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_score_candidates_chunked_matches_jax(pair):
    jcfg, cfg, jp, tp, batch = pair
    rng = np.random.default_rng(12)
    user = {k: v[:1] for k, v in batch.items()
            if k not in ("item_id", "item_cat", "label")}
    cid = rng.integers(0, cfg.item_vocab, 24).astype(np.int32)
    ccat = rng.integers(0, cfg.cat_vocab, 24).astype(np.int32)
    want = np.asarray(jbst.score_candidates_chunked(
        jp, jcfg, _j(user), jnp.asarray(cid), jnp.asarray(ccat),
        n_chunks=8))
    got = bst.score_candidates_chunked(tp, cfg, _t(user),
                                       torch.from_numpy(cid),
                                       torch.from_numpy(ccat), n_chunks=8)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # the same as forward on the user's row broadcast to the candidates
    full = {k: torch.from_numpy(np.repeat(v, 24, 0)) for k, v in user.items()}
    full.update(item_id=torch.from_numpy(cid), item_cat=torch.from_numpy(ccat))
    torch.testing.assert_close(got, bst.forward(tp, cfg, full), **F32_TOL)
    with pytest.raises(ValueError, match="chunks"):
        bst.score_candidates_chunked(tp, cfg, _t(user), torch.from_numpy(cid),
                                     torch.from_numpy(ccat), n_chunks=5)


def test_loss_and_gradient_match_jax(pair):
    jcfg, cfg, jp, tp, batch = pair
    jl, jg = jax.value_and_grad(
        lambda p: jbst.loss_fn(p, jcfg, _j(batch)))(jp)
    tl, tg = value_and_grad(lambda p, b: bst.loss_fn(p, cfg, b), tp,
                            _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    assert_grads_close(jg, tg)


def test_leaky_relu_slope_and_mask_fill():
    z = torch.tensor([-2.0, 0.0, 3.0])
    assert bst._leaky(z).tolist() == pytest.approx([-0.02, 0.0, 3.0])
    cfg = bst_arch.smoke_config()
    p = bst.init(torch.Generator().manual_seed(1), cfg)["blocks"][0]
    x = torch.randn(2, cfg.seq_len, cfg.d_item,
                    generator=torch.Generator().manual_seed(2))
    mask = torch.ones(2, cfg.seq_len)
    mask[:, :2] = 0.0
    # a masked key weighs nothing: changing it leaves the output alone
    y = x.clone()
    y[:, 0] += 5.0
    out_x, out_y = bst._mha(p, cfg, x, mask), bst._mha(p, cfg, y, mask)
    torch.testing.assert_close(out_x[:, 2:], out_y[:, 2:], **F32_TOL)


# -- configs, counts, the registry, cells and the CLI --------------------------


def test_configs_and_flops_mirror_jax():
    for fn in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(jbst_cfg, fn)()) == \
            dataclasses.asdict(getattr(bst_arch, fn)()), fn
        assert bst.flops_per_example(getattr(bst_arch, fn)()) == \
            jbst.flops_per_example(getattr(jbst_cfg, fn)())
    assert bst_arch.SHAPES == jbst_cfg.SHAPES
    assert bst_arch.SKIPPED_SHAPES == {}
    assert get_arch("bst") is bst_arch


@pytest.mark.parametrize("shape,n", [("serve_p99", 512),
                                     ("retrieval_cand", 1_000_000),
                                     ("serve_bulk", 262_144)])
def test_serve_cells_at_smoke_widths(shape, n):
    cfg = bst_arch.smoke_config()
    cell = bst_arch.make_cell(shape, cfg=cfg)
    assert cell.meta["model_flops"] == n * bst.flops_per_example(cfg)
    if shape != "serve_p99":  # a million rows: the shapes only
        return
    args = cell.make_args(0, "cpu")
    out = cell.fn(*args)
    assert out.shape == (n,) and torch.isfinite(out).all()
    torch.testing.assert_close(cell.fn(*cell.make_args(0, "cpu")), out,
                               rtol=0, atol=0)


def test_retrieval_cell_is_forward_on_the_broadcast_batch():
    cfg = bst_arch.smoke_config()
    cell = bst_arch.make_cell("retrieval_cand", cfg=cfg)
    params, user, cid, ccat = cell.make_args(0, "cpu")
    assert user["hist_ids"].shape == (1, cfg.seq_len - 1)
    assert cid.shape == ccat.shape == (1_000_000,)
    n = 64
    got = bst.score_candidates_chunked(params, cfg, user, cid[:n], ccat[:n],
                                       n_chunks=bst_arch.RETRIEVAL_CHUNKS)
    full = {k: v.expand(n, v.shape[1]) for k, v in user.items()}
    full.update(item_id=cid[:n], item_cat=ccat[:n])
    torch.testing.assert_close(got, bst.forward(params, cfg, full), **F32_TOL)


def test_train_cell_steps_at_smoke_widths():
    cfg = bst_arch.smoke_config()
    cell = bst_arch.make_cell("train_batch", cfg=cfg)
    assert cell.kind == "train"
    assert cell.meta["model_flops"] == 3 * 65_536 * bst.flops_per_example(cfg)
    state, batch = cell.make_args(0, "cpu")
    small = {k: v[:256] for k, v in batch.items()}
    losses = []
    for _ in range(3):
        state, loss = cell.fn(state, small)
        losses.append(float(loss))
    assert int(state.step) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_cells_cli_runs_bst_on_the_cpu(capsys):
    from repro_torch.launch import cells

    assert cells.main(["--arch", "bst", "--shape", "serve_p99", "--preset",
                       "smoke", "--device", "cpu", "--calls", "2"]) == 0
    out = capsys.readouterr().out
    assert "bst x serve_p99" in out and out.count("checksum") == 2
