"""The model zoo's DLRM-RM2 and xDeepFM: the JAX package against the port.

* the kernels' plain versions (what the wrappers run on the CPU) against
  the JAX package's Pallas kernels in interpret mode: dot interaction
  2e-5 in f32 and 2e-2 in bf16 (one bf16 rounding of an f32 sum taken
  in another order), CIN 1e-4 (f32 sums over up to 7,800 terms);
* ``forward`` and ``retrieval_forward`` of both models at
  ``smoke_config()`` on JAX weights carried over by the bridge: 1e-5
  with f32 tables, 2e-2 with the default bf16 tables (bf16 rounds at
  other places in the two frameworks);
* bf16 leaves cross the bridge bit for bit, from a numpy tree and from a
  checkpoint directory; the bridge refuses a leaf of another dtype;
* the registry, the cells and their CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as jdlrm_cfg
from repro.configs import xdeepfm_arch as jxdfm_cfg
from repro.kernels import ops as jops
from repro.models.recsys import dlrm as jdlrm
from repro.models.recsys import xdeepfm as jxdfm
from repro.training import checkpoint
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, dlrm_rm2, get_arch, xdeepfm_arch
from repro_torch.core import flops
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.recsys import dlrm, xdeepfm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


# -- kernels ----------------------------------------------------------------


@pytest.mark.parametrize("b,f,d", [(32, 27, 64), (7, 13, 32)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dot_interact_matches_pallas(b, f, d, bf16):
    x = np.random.default_rng(b + d).normal(size=(b, f, d)) \
        .astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bf16:  # both round to nearest even: the same bits
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    got = ops.dot_interact(tx)
    want = jops.dot_interact(jx)
    assert got.dtype == tx.dtype and got.shape == (b, f * (f - 1) // 2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(BF16_TOL if bf16 else dict(rtol=2e-5,
                                                             atol=2e-5)))


@pytest.mark.parametrize("b,hp,m,d,ho", [(8, 39, 39, 10, 200),
                                         (5, 8, 12, 4, 16)])
def test_cin_layer_matches_pallas(b, hp, m, d, ho):
    rng = np.random.default_rng(hp + ho)
    w = (0.05 * rng.normal(size=(ho, hp * m))).astype(np.float32)
    xp = rng.normal(size=(b, hp, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    got = ops.cin_layer(*map(torch.from_numpy, (w, xp, x0))).numpy()
    want = np.asarray(jops.cin_layer(*map(jnp.asarray, (w, xp, x0))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cin_layer_plain_version_chunks_the_batch():
    """The plain version forms Z a chunk of samples at a time; the
    chunking changes only the matmul's summation order."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(6, 5 * 3, generator=gen)
    xp, x0 = torch.randn(11, 5, 2, generator=gen), \
        torch.randn(11, 3, 2, generator=gen)
    from repro_torch.kernels.ref import cin_layer_ref
    whole = cin_layer_ref(w, xp, x0)
    torch.testing.assert_close(cin_layer_ref(w, xp, x0, chunk_elems=60),
                               whole, rtol=1e-5, atol=1e-5)
    assert cin_layer_ref(w, xp[:0], x0[:0]).shape == (0, 6, 2)


# -- models on bridged weights ----------------------------------------------


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


MODELS = {
    "dlrm": (jdlrm_cfg, jdlrm, dlrm_rm2, dlrm),
    "xdeepfm": (jxdfm_cfg, jxdfm, xdeepfm_arch, xdeepfm),
}


def _pair(name, f32):
    """JAX and port configs, JAX params and their bridged port twin."""
    jcfg_mod, jmodel, cfg_mod, model = MODELS[name]
    jcfg, cfg = jcfg_mod.smoke_config(), cfg_mod.smoke_config()
    if f32:
        kw = dict(table_dtype="float32", lookup_dtype="float32")
        jcfg, cfg = dataclasses.replace(jcfg, **kw), \
            dataclasses.replace(cfg, **kw)
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    like = model.init(torch.Generator().manual_seed(0), cfg)
    tp = bridge.from_numpy_tree(_np_tree(jp), like=like, device="cpu")
    return jcfg, cfg, jp, tp


def _batch(name, cfg, n=16):
    rng = np.random.default_rng(7)
    _, _, cfg_mod, _ = MODELS[name]
    return {k: v.numpy() for k, v in cfg_mod.smoke_batch(rng, cfg).items()
            if k != "label"}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("f32", [True, False])
def test_forward_matches_jax(name, f32):
    jcfg, cfg, jp, tp = _pair(name, f32)
    _, jmodel, _, model = MODELS[name]
    batch = _batch(name, cfg)
    want = np.asarray(jmodel.forward(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = model.forward(tp, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **(F32_TOL if f32 else BF16_TOL))


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("f32", [True, False])
def test_retrieval_forward_matches_jax(name, f32):
    jcfg, cfg, jp, tp = _pair(name, f32)
    _, jmodel, cfg_mod, model = MODELS[name]
    user = {k: v[:1] for k, v in _batch(name, cfg).items()}
    k = cfg_mod.N_ITEM_FIELDS
    cand = np.random.default_rng(9).integers(
        0, 32, (40, k)).astype(np.int32)
    want = np.asarray(jmodel.retrieval_forward(
        jp, jcfg, {a: jnp.asarray(v) for a, v in user.items()},
        jnp.asarray(cand)))
    got = model.retrieval_forward(
        tp, cfg, {a: torch.from_numpy(v) for a, v in user.items()},
        torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), want,
                               **(F32_TOL if f32 else BF16_TOL))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_retrieval_forward_is_forward_on_the_broadcast_batch(name):
    _, cfg, _, tp = _pair(name, True)
    _, _, cfg_mod, model = MODELS[name]
    batch = {k: torch.from_numpy(v) for k, v in _batch(name, cfg).items()}
    k = cfg_mod.N_ITEM_FIELDS
    user = {a: v[:1] for a, v in batch.items()}
    cand = batch["sparse"][:, -k:]
    full = {a: v[:1].expand_as(v).clone() for a, v in batch.items()}
    full["sparse"][:, -k:] = cand
    torch.testing.assert_close(model.retrieval_forward(tp, cfg, user, cand),
                               model.forward(tp, cfg, full), rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flops_per_example_matches_jax(name):
    jcfg_mod, jmodel, cfg_mod, model = MODELS[name]
    for jc, c in ((jcfg_mod.full_config(), cfg_mod.full_config()),
                  (jcfg_mod.smoke_config(), cfg_mod.smoke_config())):
        assert model.flops_per_example(c) == jmodel.flops_per_example(jc)


def test_mlp_flops_matches_jax():
    from repro.core import flops as jflops
    for dims in ([13, 512, 256, 64], [512, 512, 256, 1], [390, 400, 400, 1]):
        assert flops.mlp_flops(dims) == jflops.mlp_flops(dims)
        assert flops.mlp_flops(dims, 7) == jflops.mlp_flops(dims, 7)


def test_configs_mirror_jax():
    for jcfg_mod, _, cfg_mod, _ in MODELS.values():
        for fn in ("full_config", "smoke_config"):
            a = dataclasses.asdict(getattr(jcfg_mod, fn)())
            b = dataclasses.asdict(getattr(cfg_mod, fn)())
            a = {k: v for k, v in a.items() if k in b}  # no mesh fields
            assert a == b, fn
        assert cfg_mod.PAD_TO == jcfg_mod.PAD_TO
        assert cfg_mod.N_ITEM_FIELDS == jcfg_mod.N_ITEM_FIELDS
    assert sum(dlrm.CRITEO_VOCABS) == 78_046_168
    assert sum(xdeepfm.XDEEPFM_VOCABS) == 79_984_968


# -- the bridge --------------------------------------------------------------


def _bf16_tree():
    x = np.random.default_rng(1).normal(size=(37, 5)).astype(np.float32)
    x[0, :3] = [np.inf, -0.0, 1e-40]  # an edge or two
    return {"tables": {"stacked": x.astype(ml_dtypes.bfloat16)},
            "mlp": [{"w": x[:3, :2].copy()}]}


def _bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_bridge_carries_bf16_leaves_bitwise():
    tree = _bf16_tree()
    out = bridge.from_numpy_tree(tree, device="cpu")
    t = out["tables"]["stacked"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (37, 5)
    np.testing.assert_array_equal(
        _bits(t), tree["tables"]["stacked"].view(np.uint16))
    assert out["mlp"][0]["w"].dtype == torch.float32


def test_bridge_reads_bf16_checkpoint_bitwise(tmp_path):
    tree = _bf16_tree()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    checkpoint.save(str(tmp_path), 5, jtree)
    loaded, manifest = bridge.load_checkpoint(str(tmp_path))
    assert manifest["step"] == 5
    like = {"tables": {"stacked": torch.zeros(37, 5,
                                              dtype=torch.bfloat16)},
            "mlp": [{"w": torch.zeros(3, 2)}]}
    out = bridge.from_numpy_tree(loaded, like=like, device="cpu")
    np.testing.assert_array_equal(
        _bits(out["tables"]["stacked"]),
        tree["tables"]["stacked"].view(np.uint16))
    np.testing.assert_array_equal(out["mlp"][0]["w"].numpy(),
                                  tree["mlp"][0]["w"])


def test_bridge_refuses_another_dtype():
    tree = _bf16_tree()
    like = {"tables": {"stacked": torch.zeros(37, 5)},  # f32
            "mlp": [{"w": torch.zeros(3, 2)}]}
    with pytest.raises(ValueError, match="dtype"):
        bridge.from_numpy_tree(tree, like=like, device="cpu")


# -- layers -----------------------------------------------------------------


def test_normal_table_is_drawn_in_chunks_on_its_generator():
    def draw(chunk, dtype=torch.float32):
        return L.normal_table(torch.Generator().manual_seed(4), 4000, 3,
                              std=0.5, dtype=dtype, chunk_rows=chunk)

    parts = draw(1000)
    torch.testing.assert_close(draw(1000), parts, rtol=0, atol=0)
    assert parts.shape == (4000, 3) and abs(float(parts.std()) - 0.5) < 0.02
    bf = draw(1000, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, parts.to(torch.bfloat16), rtol=0,
                               atol=0)
    gen = torch.Generator().manual_seed(0)
    assert L.dense_init(gen, 4, 2, dtype=torch.bfloat16)["w"].dtype == \
        torch.bfloat16


# -- registry, cells and the CLI --------------------------------------------


def test_registry_names_what_waits():
    assert get_arch("dlrm-rm2") is dlrm_rm2
    assert get_arch("xdeepfm") is xdeepfm_arch
    # every arch of the JAX package is ported; the MoE LMs last
    # (ROADMAP queue A item 16)
    for arch, name in (("bst", "bst_arch"), ("schnet", "schnet"),
                       ("glm4-9b", "glm4_9b"), ("minicpm-2b", "minicpm_2b"),
                       ("granite-moe-1b-a400m", "granite_moe_1b_a400m"),
                       ("olmoe-1b-7b", "olmoe_1b_7b")):
        assert get_arch(arch).__name__ == f"repro_torch.configs.{name}"
    assert all(get_arch(a).ARCH_ID == a for a in ARCH_IDS)
    with pytest.raises(KeyError):
        get_arch("nope")
    # train_batch is ported (ROADMAP queue A item 25): the hybrid cell
    for mod in (dlrm_rm2, xdeepfm_arch):
        assert "train_batch" in mod.SHAPES and mod.SKIPPED_SHAPES == {}
        cell = mod.make_cell("train_batch")
        assert cell.kind == "train" and "hybrid" in cell.meta["optimizer"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cells_at_smoke_widths(name):
    _, _, cfg_mod, model = MODELS[name]
    cfg = cfg_mod.smoke_config()
    cell = cfg_mod.make_cell("serve_p99", cfg=cfg)
    params, batch = cell.make_args(0, "cpu")
    assert batch["sparse"].shape == (512, cfg.n_sparse)
    assert (batch["sparse"] < torch.tensor(cfg.vocab_sizes)).all()
    out = cell.fn(params, batch)
    assert out.shape == (512,) and torch.isfinite(out).all()
    assert cell.meta["model_flops"] == 512 * model.flops_per_example(cfg)
    # the same seed gives the same arguments
    params2, batch2 = cell.make_args(0, "cpu")
    torch.testing.assert_close(cell.fn(params2, batch2), out, rtol=0, atol=0)


def test_cells_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import cells

    assert cells.main(["--arch", "xdeepfm", "--shape", "serve_p99",
                       "--preset", "smoke", "--device", "cpu",
                       "--calls", "2"]) == 0
    out = capsys.readouterr().out
    assert "xdeepfm x serve_p99" in out and out.count("checksum") == 2


def test_cells_cli_raises_without_a_card(monkeypatch):
    from repro_torch.launch import cells

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.main(["--arch", "dlrm-rm2", "--shape", "serve_p99",
                    "--preset", "smoke"])
