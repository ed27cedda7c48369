"""The MoE LMs, granite-moe-1b-a400m and olmoe-1b-7b, on the port, on the
CPU.

At each ``smoke_config()`` (f32) on JAX ``lm.init`` weights carried over
by the bridge:
* the port's ``_moe_ref`` (every expert computed) against JAX's
  ``_moe_ref``: out and router aux within 1e-5;
* ``_moe_grouped`` (what every cell runs: tokens grouped by expert)
  against ``_moe_ref`` within 1e-5, also with an expert no token picks
  and with fewer tokens than experts, forward and every gradient;
* forward logits, the loss with its aux term and the gradient of every
  leaf against ``jax.value_and_grad(lm.loss_fn)`` within 1e-5 (of each
  gradient's largest magnitude);
* prefill (logits and cache) and decode steps against JAX's;
* the loss and gradients repeat bitwise, with the layers checkpointed
  or not; every token gets exactly k expert rows (none dropped).
The configs, counts, registry and cells mirror the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import granite_moe_1b_a400m as jgranite
from repro.configs import olmoe_1b_7b as jolmoe
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import (base, get_arch, granite_moe_1b_a400m,
                                 olmoe_1b_7b)
from repro_torch.models import lm
from repro_torch.tree import leaves, tree_map
from torch_parity import F32_TOL, leaf_at, np_tree

ARCHS = {"granite-moe-1b-a400m": (jgranite, granite_moe_1b_a400m),
         "olmoe-1b-7b": (jolmoe, olmoe_1b_7b)}
CUT = {"granite-moe-1b-a400m": {"prefill_32k": 4, "decode_32k": 32},
       "olmoe-1b-7b": {"prefill_32k": 4, "decode_32k": 12}}
TOL = 1e-5


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    jmod, mod = ARCHS[request.param]
    jcfg, cfg = jmod.smoke_config(), mod.smoke_config()
    jp = jlm.init(jax.random.PRNGKey(5), jcfg)
    like = lm.init(torch.Generator().manual_seed(0), cfg)
    tp = bridge.from_numpy_tree(np_tree(jp), like=like, device="cpu")
    batch = jbase.lm_smoke_batch(np.random.default_rng(11), jcfg)
    return jcfg, cfg, jp, tp, {k: np.array(v) for k, v in batch.items()}


def _layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            lm._layer(tp, 0))


def _x(cfg, b, t, seed):
    return np.random.default_rng(seed).normal(
        size=(b, t, cfg.d_model)).astype(np.float32)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(fn, params):
    """(value, gradient tree) of fn(params) by autograd, on a copy of
    the f32 leaves that requires grad."""
    p = tree_map(lambda v: v.detach().clone().requires_grad_(True), params)
    val = fn(p)
    val.backward()
    return val.detach(), tree_map(lambda v: v.grad, p)


def _assert_close(got, want, scale=None):
    want = np.asarray(want, np.float32)
    scale = scale if scale is not None else max(float(np.abs(want).max()),
                                                1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=TOL, atol=TOL * scale)


# -- the FFN alone -------------------------------------------------------------


def test_moe_ref_matches_jax(pair):
    jcfg, cfg, jp, tp, _ = pair
    jl, tl = _layer0(jp, tp)
    x = _x(cfg, 2, 12, 1)
    want, waux = jlm._moe_ref(jl, jcfg, jnp.asarray(x))
    got, aux = lm._moe_ref(tl, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), **F32_TOL)
    assert float(aux) > 0


def _moe_case(cfg, tl, case):
    """(layer params, x) of a grouped-vs-plain case: "random" tokens,
    "unpicked" (every token's first feature 4 and expert 1's router
    column -100 there and 0 elsewhere, so no token picks it) and "few"
    (fewer tokens than experts)."""
    x = _x(cfg, 2, 9, 3)
    if case == "few":
        x = x[:1, :cfg.moe.n_experts - 1]
    if case == "unpicked":
        x[..., 0] = 4.0
        tl = dict(tl, router=tl["router"].clone())
        tl["router"][:, 1] = 0.0
        tl["router"][0, 1] = -100.0
    return tl, torch.from_numpy(x)


@pytest.mark.parametrize("case", ["random", "unpicked", "few"])
def test_grouped_matches_ref_forward_and_grads(pair, case):
    _, cfg, jp, tp, _ = pair
    tl, x = _moe_case(cfg, _layer0(jp, tp)[1], case)
    n = x.shape[0] * x.shape[1]
    _, _, top_e = lm._route(tl, cfg, x.reshape(n, cfg.d_model))
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.moe.n_experts)
    if case == "unpicked":
        assert counts[1] == 0
    if case == "few":
        assert n < cfg.moe.n_experts
    cot = torch.from_numpy(_x(cfg, x.shape[0], x.shape[1], 4))

    def run(fn):
        leaves_in = {"x": x, **tl}

        def loss(p):
            out, aux = fn({k: v for k, v in p.items() if k != "x"}, cfg,
                          p["x"])
            return (out * cot).sum() + aux

        with torch.no_grad():
            out, aux = fn(tl, cfg, x)
        return out, aux, _grads(loss, leaves_in)[1]

    got, gaux, ggrad = run(lm._moe_grouped)
    want, waux, wgrad = run(lm._moe_ref)
    _assert_close(got.numpy(), want.numpy())
    _assert_close(float(gaux), float(waux))
    for name in ("x", "router", "w1", "w2", "w3"):
        _assert_close(ggrad[name].numpy(), wgrad[name].numpy())
    if case == "unpicked":  # no row, no gradient
        assert not ggrad["w1"][1].any() and not ggrad["w2"][1].any()


def test_every_token_gets_k_rows(pair):
    _, cfg, jp, tp, _ = pair
    tl = _layer0(jp, tp)[1]
    n, k = 40, cfg.moe.top_k
    xt = torch.from_numpy(_x(cfg, 1, n, 6)[0])
    _, _, top_e = lm._route(tl, cfg, xt)
    order, inverse, counts = lm._dispatch(top_e, cfg.moe.n_experts)
    assert int(counts.sum()) == n * k
    assert torch.equal(torch.sort(order).values, torch.arange(n * k))
    assert torch.equal(order[inverse], torch.arange(n * k))
    # each token's k rows, each to one of its own k distinct experts
    assert torch.equal(torch.bincount(order // k, minlength=n),
                       torch.full((n,), k))
    assert torch.equal(top_e.reshape(-1)[order],
                       torch.sort(top_e.reshape(-1), stable=True).values)
    assert all(len(set(r)) == k for r in top_e.tolist())
    before = lm.HOST_READS["moe_counts"]
    lm._moe_grouped(tl, cfg, xt[None])
    assert lm.HOST_READS["moe_counts"] == before + 1


# -- the model -------------------------------------------------------------


def test_forward_loss_and_grads_match_jax(pair):
    jcfg, cfg, jp, tp, batch = pair
    toks = batch["tokens"]
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got = lm.forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    jl, jg = jax.value_and_grad(jlm.loss_fn)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _grads(lambda p: lm.loss_fn(p, cfg, _torch_batch(batch)), tp)
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for path, want_g in flat:
        _assert_close(leaf_at(tg, path).numpy(), want_g)
    assert len(flat) == len(leaves(tg))
    names = set(tg["layers"])
    assert {"router", "w1", "w2", "w3"} <= names
    assert ({"q_norm", "k_norm"} <= names) == cfg.qk_norm


def test_loss_holds_the_router_aux(pair):
    """The loss is the masked NLL plus router_aux_weight x the layers'
    mean aux, as JAX's: the NLL alone is what forward's logits give."""
    _, cfg, _, tp, batch = pair
    tb = _torch_batch(batch)
    with torch.no_grad():
        loss = lm.loss_fn(tp, cfg, tb)
        x, aux = lm._hidden(tp, cfg, tb["tokens"])
        logits = lm.forward(tp, cfg, tb["tokens"]).float()
    nll = (torch.logsumexp(logits, -1)
           - torch.gather(logits, -1, tb["targets"].long()[..., None])[..., 0])
    want = (nll * tb["mask"]).sum() / tb["mask"].sum() \
        + cfg.moe.router_aux_weight * aux / cfg.n_layers
    assert float(aux) > 0
    torch.testing.assert_close(loss, want, **F32_TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill 16 tokens into a 24-position cache, then decode steps on
    JAX's greedy tokens: logits and cache within 1e-5."""
    jcfg, cfg, jp, tp, batch = pair
    toks = batch["tokens"]
    jl, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), max_len=24)
    tl, tc = lm.prefill(tp, cfg, torch.from_numpy(toks), max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        assert tc["length"] == int(jc["length"]) == 17 + step
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)


def test_decode_step_equals_prefill_of_one_more_token(pair):
    """The identity the card checks at full width, at smoke widths."""
    _, cfg, _, tp, batch = pair
    t = torch.from_numpy(batch["tokens"])
    _, cache = lm.prefill(tp, cfg, t[:, :-1], max_len=24)
    got, _ = lm.decode_step(tp, cfg, t[:, -1], cache)
    want, _ = lm.prefill(tp, cfg, t, max_len=24)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_loss_and_grads_repeat_bitwise_with_remat_on_or_off(pair):
    _, cfg, _, tp, batch = pair
    tb = _torch_batch(batch)
    runs = [_grads(lambda p, c=c: lm.loss_fn(p, c, tb), tp)
            for c in (cfg, cfg, dataclasses.replace(cfg, remat=True))]
    for loss, grads in runs[1:]:
        torch.testing.assert_close(loss, runs[0][0], rtol=0, atol=0)
        for g, w in zip(leaves(grads), leaves(runs[0][1])):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bf16_grouped_within_bf16_of_the_plain_version(pair):
    """bf16 activations and weights: the grouped path and the plain one
    route alike (one ``_route``) and agree within 2e-2."""
    _, cfg, jp, tp, _ = pair
    tl = {k: v if isinstance(v, dict) else v.to(torch.bfloat16)
          for k, v in _layer0(jp, tp)[1].items()}
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    x = torch.from_numpy(_x(cfg, 2, 16, 8)).to(torch.bfloat16)
    got, gaux = lm._moe_grouped(tl, cfg16, x)
    want, waux = lm._moe_ref(tl, cfg16, x)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * float(want.float().abs().max()))
    torch.testing.assert_close(gaux, waux, rtol=0, atol=0)


# -- configs, counts, registry and cells ---------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_and_counts_mirror_jax(arch):
    jmod, mod = ARCHS[arch]
    for fn in ("full_config", "smoke_config"):
        a = dataclasses.asdict(getattr(jmod, fn)())
        b = dataclasses.asdict(getattr(mod, fn)())
        assert {k: v for k, v in a.items() if k in b} == b, fn
        jc, c = getattr(jmod, fn)(), getattr(mod, fn)()
        assert c.n_params() == jc.n_params()
        assert c.n_active_params() == jc.n_active_params()
        for decode in (False, True):
            assert lm.flops_per_token(c, 4096, decode=decode) == \
                jlm.flops_per_token(jc, 4096, decode=decode)
    assert mod.SHAPES == jmod.SHAPES
    assert mod.SKIPPED_SHAPES == jmod.SKIPPED_SHAPES
    assert get_arch(arch) is mod
    want = {"granite-moe-1b-a400m": 1_334_887_424,
            "olmoe-1b-7b": 6_919_620_608}[arch]
    assert mod.full_config().n_params() == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_cells_cut_batch_and_train_depth_only(arch):
    """The cuts of the config module's docstring, every width kept, and
    model_flops as the JAX cells count them at the JAX batch (top-k
    active parameters)."""
    jmod, mod = ARCHS[arch]
    for shape in ("prefill_32k", "decode_32k"):
        cell = mod.make_cell(shape)
        assert (cell.meta["batch"], cell.meta["seq"]) == \
            (CUT[arch][shape], 32768)
        info = jbase.LM_SHAPES[shape]
        jcell = jbase._lm_cell_raw(arch, jmod.full_config(), shape)
        assert base.lm_model_flops(mod.full_config(), info["kind"],
                                   info["batch"], info["seq"]) == \
            jcell.meta["model_flops"]
    cell = mod.make_cell("train_4k")
    assert cell.kind == "train" and cell.meta["batch"] == 8
    assert cell.meta["n_microbatches"] == 2
    layers = getattr(mod, "TRAIN_LAYERS", mod.full_config().n_layers)
    assert cell.meta["n_layers"] == layers
    assert ("n_layers" in cell.meta["cuts"]) == (
        layers < mod.full_config().n_layers)
    with pytest.raises(NotImplementedError, match="full-attention"):
        mod.make_cell("long_500k")


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_cells_at_smoke_widths(arch, shape):
    _, mod = ARCHS[arch]
    cfg = mod.smoke_config()
    cell = mod.make_cell(shape, cfg=cfg)
    args = cell.make_args(0, "cpu")
    out = cell.fn(*args)
    if shape == "train_4k":
        state, loss = out
        assert int(state.step) == 1 and torch.isfinite(loss)
        return
    assert out.shape == (base.LM_SMOKE_BATCH, cfg.padded_vocab)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_gather_matches_indexing_and_sums_slots_in_order(dtype):
    """``_Permute`` with k > 1 gathers ``xt[order // k]`` straight from
    the tokens; its gradient (the inverse permutation, then each
    token's k slots summed in slot order) equals autograd through that
    indexing and repeats bitwise."""
    n, k, d, e = 37, 4, 24, 6
    rng = np.random.default_rng(3)
    top_e = torch.from_numpy(np.stack(
        [rng.permutation(e)[:k] for _ in range(n)]))
    order, inverse, _ = lm._dispatch(top_e, e)
    xt = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                          ).to(dtype)
    cot = torch.from_numpy(rng.normal(size=(n * k, d)).astype(np.float32)
                           ).to(dtype)

    def run(gather, x, g):
        x = x.clone().requires_grad_(True)
        rows = gather(x)
        rows.backward(g)
        return rows.detach(), x.grad

    got = run(lambda x: lm._Permute.apply(x, order, inverse, k), xt, cot)
    # the indexing in f32 on the same values: a bf16 gradient is its sum
    # rounded once
    want = run(lambda x: x[order // k], xt.float(), cot.float())
    assert torch.equal(got[0].float(), want[0])
    rtol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got[1].float(), want[1], rtol=rtol,
                               atol=1e-6)
    again = run(lambda x: lm._Permute.apply(x, order, inverse, k), xt, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
