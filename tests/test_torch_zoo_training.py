"""Training DLRM-RM2, xDeepFM and the dense LMs on the port against the
JAX package's train steps, on the CPU.

At ``smoke_config()`` on JAX's init carried over by ``bridge.
from_numpy_tree``, on the same batches:

* DLRM's and xDeepFM's ``train_batch`` cells (the hybrid optimizer:
  stateless SGD at 0.04 on the embedding tables, AdamW at 1e-3 without
  weight decay on the dense leaves) against the JAX cells' own step
  (``_hybrid_train_cell(...).fn``), two steps: the loss and the f32
  leaves within 1e-5, the bf16 tables within 2e-2 (bf16 rounds at other
  places in the two frameworks);
* gemma2-2b's, glm4-9b's and minicpm-2b's ``train_4k`` cells (AdamW, weight
  decay 0.1, lr 3e-4, 2 microbatches) against the JAX ``lm_train_cell``'s
  step written out (its closure fixes B = 256): its microbatch loop, the
  gradients summed then divided, two steps, within 1e-5;
* ``remat`` on equals ``remat`` off bit for bit;
* the cells' sizes and cuts against the JAX cells; the training CLI on
  every newly trainable arch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as jdlrm_cfg
from repro.configs import gemma2_2b as jgemma
from repro.configs import glm4_9b as jglm4
from repro.configs import minicpm_2b as jminicpm
from repro.configs import xdeepfm_arch as jxdfm_cfg
from repro.models import lm as jlm
from repro.models.recsys import dlrm as jdlrm
from repro.models.recsys import xdeepfm as jxdfm
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import dlrm_rm2, gemma2_2b, glm4_9b, minicpm_2b
from repro_torch.configs import xdeepfm_arch
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.models.recsys import dlrm, xdeepfm
from repro_torch.training.optimizer import AdamW
from repro_torch.training.trainer import TrainState, init_state, value_and_grad
from repro_torch.tree import leaves_with_paths
from torch_parity import leaf_at, np_tree

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

RECSYS = {"dlrm-rm2": (jdlrm_cfg, jdlrm, dlrm_rm2, dlrm, ("tables",)),
          "xdeepfm": (jxdfm_cfg, jxdfm, xdeepfm_arch, xdeepfm,
                      ("tables", "linear"))}
LMS = {"gemma2-2b": (jgemma, gemma2_2b), "glm4-9b": (jglm4, glm4_9b),
       "minicpm-2b": (jminicpm, minicpm_2b)}


def _assert_tree_close(tparams, jparams):
    """Every leaf of the port's tree against the JAX tree's: f32 within
    1e-5, bf16 within 2e-2."""
    n = 0
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        got = leaf_at(tparams, path)
        tol = BF16_TOL if got.dtype == torch.bfloat16 else STEP_TOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(leaves_with_paths(tparams))


@pytest.mark.parametrize("arch", sorted(RECSYS))
def test_hybrid_train_step_matches_jax(arch):
    jcfg_mod, jmodel, mod, model, emb = RECSYS[arch]
    jcfg, cfg = jcfg_mod.smoke_config(), mod.smoke_config()
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_numpy_tree(
        np_tree(jparams), like=model.init(torch.Generator().manual_seed(0),
                                          cfg), device="cpu")
    assert params["tables"]["stacked"].dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    batches = [mod.smoke_batch(rng, cfg) for _ in range(2)]
    jbatch, bspec = jcfg_mod._batch(jcfg, 16)
    jcell = jcfg_mod._hybrid_train_cell(jcfg, jparams,
                                        jcfg_mod._pspec(jparams), jbatch,
                                        bspec, 16)
    dense = {k: v for k, v in jparams.items() if k not in emb}
    jstate = jtrainer.TrainState(jnp.zeros((), jnp.int32), jparams,
                                 jopt.AdamW().init(dense))
    cell = mod.make_cell("train_batch", cfg)
    state = TrainState(torch.zeros((), dtype=torch.int32), params,
                       AdamW().init({k: v for k, v in params.items()
                                     if k not in emb}))
    for b in batches:
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        jstate, jl = jcell.fn(jstate, jb)
        state, loss = cell.fn(state, b)
        np.testing.assert_allclose(float(loss), float(jl), **STEP_TOL)
    assert int(state.step) == 2
    _assert_tree_close(state.params, jstate.params)
    _assert_tree_close(state.opt_state.mu, jstate.opt_state.mu)


def _lm_pair(arch, **over):
    jmod, mod = LMS[arch]
    jcfg = dataclasses.replace(jmod.smoke_config(), **over)
    cfg = dataclasses.replace(mod.smoke_config(), **over)
    jparams = jlm.init(jax.random.PRNGKey(2), jcfg)
    params = bridge.from_numpy_tree(
        np_tree(jparams), like=lm.init(torch.Generator().manual_seed(0), cfg),
        device="cpu")
    return jcfg, cfg, jparams, params


def _jax_lm_step(jcfg, params, opt_state, batch, n_micro):
    """The JAX ``lm_train_cell`` step, its microbatch loop written out."""
    rows = batch["tokens"].shape[0] // n_micro
    loss, grads = 0.0, None
    for m in range(n_micro):
        mb = {k: v[m * rows:(m + 1) * rows] for k, v in batch.items()}
        lm_, g = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, mb))(params)
        loss = loss + lm_ / n_micro
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    grads = jax.tree_util.tree_map(lambda g: g / n_micro, grads)
    return (*jopt.AdamW(weight_decay=0.1).update(grads, opt_state, params,
                                                 3e-4), loss)


@pytest.mark.parametrize("arch", sorted(LMS))
def test_lm_train_4k_step_matches_jax(arch):
    jcfg, cfg, jparams, params = _lm_pair(arch)
    cell = LMS[arch][1].make_cell("train_4k", cfg)
    assert cell.meta["n_microbatches"] == 2
    _, batch = cell.make_args(0, "cpu")
    assert batch["tokens"].shape == (2, 64)
    state = init_state(params, AdamW(weight_decay=0.1))
    jopt_state = jopt.AdamW(weight_decay=0.1).init(jparams)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for _ in range(2):
        jparams, jopt_state, jl = _jax_lm_step(jcfg, jparams, jopt_state,
                                               jb, 2)
        state, loss = cell.fn(state, batch)
        np.testing.assert_allclose(float(loss), float(jl), **STEP_TOL)
    _assert_tree_close(state.params, jparams)


@pytest.mark.parametrize("arch", sorted(LMS))
def test_lm_remat_on_equals_off_bitwise(arch):
    """Checkpointing each layer recomputes it in the backward pass: the
    same ops on the same inputs, so the loss and every gradient are the
    same bits (the CPU is deterministic)."""
    _, cfg, _, params = _lm_pair(arch)
    _, batch = LMS[arch][1].make_cell("train_4k", cfg).make_args(0, "cpu")
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(lambda p, b: lm.loss_fn(p, c, b),
                                    params, batch)
    assert torch.equal(out[False][0], out[True][0])
    for (p, a), (_, b) in zip(leaves_with_paths(out[False][1]),
                              leaves_with_paths(out[True][1])):
        assert torch.equal(a, b), p


def test_lm_loss_chunks_match_the_whole():
    """The logits are formed ``LOSS_CHUNK`` positions at a time: the same
    per-position NLL as one pass, the loss within f32 rounding."""
    _, cfg, _, params = _lm_pair("gemma2-2b")
    _, batch = gemma2_2b.make_cell("train_4k", cfg).make_args(3, "cpu")
    batch["mask"][0, :7] = 0.0
    whole = lm.loss_fn(params, cfg, batch)
    saved = lm.LOSS_CHUNK
    try:
        lm.LOSS_CHUNK = 24  # 128 positions: 6 chunks, the last ragged
        chunked, grads = value_and_grad(
            lambda p, b: lm.loss_fn(p, cfg, b), params, batch)
    finally:
        lm.LOSS_CHUNK = saved
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
    _, want = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b), params,
                             batch)
    for (p, a), (_, b) in zip(leaves_with_paths(grads),
                              leaves_with_paths(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=p)


@pytest.mark.parametrize("arch", sorted(LMS))
def test_lm_train_cells_cut_batch_and_depth(arch):
    """train_4k at the full widths: B = 8 (JAX 256) of 4,096 positions in
    2 microbatches; glm4-9b at 12 of 40 layers; model_flops = 6 x active
    parameters x tokens, as the JAX cell counts them at the cut depth."""
    jmod, mod = LMS[arch]
    cell = mod.make_cell("train_4k")
    jcfg = jmod.full_config()
    layers = 12 if arch == "glm4-9b" else jcfg.n_layers
    jcfg = dataclasses.replace(jcfg, n_layers=layers)
    assert cell.meta["n_layers"] == layers
    assert cell.meta["cuts"]["batch"] == "256 -> 8"
    assert ("n_layers" in cell.meta["cuts"]) == (arch == "glm4-9b")
    assert cell.meta["n_tokens"] == 8 * 4096
    assert cell.meta["model_flops"] == pytest.approx(
        6.0 * jcfg.n_active_params() * 8 * 4096)


@pytest.mark.parametrize("arch", sorted(RECSYS))
def test_hybrid_cells_count_three_forwards(arch):
    _, _, mod, model, emb = RECSYS[arch]
    cell = mod.make_cell("train_batch")
    assert cell.kind == "train" and mod.EMB_KEYS == emb
    assert cell.meta["model_flops"] == pytest.approx(
        3 * 65_536 * model.flops_per_example(mod.full_config()))


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm", "gemma2-2b",
                                  "glm4-9b", "minicpm-2b"])
def test_train_cli_trains_each_arch_on_the_cpu(arch, capsys):
    assert train_cli.main(["--arch", arch, "--device", "cpu", "--steps",
                           "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "final_loss=" in out
    assert "nan" not in out
