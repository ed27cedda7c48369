"""The LM slice: the JAX package against the port, on the CPU.

* the flash-attention kernel's plain version (what ``ops.flash_attention``
  runs on CPU tensors) against the JAX package's Pallas kernel in
  interpret mode and its jnp oracle: 2e-5 in f32, 2e-2 in bf16 (the
  logits round to bf16 out of the first einsum in both plain versions,
  the Pallas kernel keeps them in f32);
* ``forward``, ``prefill`` (logits and cache) and 4 ``decode_step``s of
  gemma2-2b's ``smoke_config`` and of a dense config with QK-norm,
  partial RoPE, minicpm-style residual scale and logit divisor and an
  untied head, on JAX ``lm.init`` weights carried over by the bridge:
  1e-5 in f32; gemma2's forward, prefill and decode also in bf16, 2e-2;
* the norm, RoPE, parameter and FLOP counts, the registry, the cells and
  their CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import gemma2_2b as jgemma
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import base, gemma2_2b, get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import lm

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _tol(bf16):
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5,
                                                        atol=2e-5)


# -- flash attention ---------------------------------------------------------


def _qkv(b, t, s, h, hk, d, seed, bf16):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, hk, d), (b, s, hk, d))]
    js = [jnp.asarray(a) for a in arrs]
    ts = [torch.from_numpy(a) for a in arrs]
    if bf16:  # both round to nearest even: the same bits
        js = [a.astype(jnp.bfloat16) for a in js]
        ts = [a.to(torch.bfloat16) for a in ts]
    return js, ts


def _check_flash(js, ts, bf16, **kw):
    got = ops.flash_attention(*ts, **kw)
    also = ref.flash_attention_ref(*ts, **kw)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    torch.testing.assert_close(got, also, rtol=0, atol=0)
    pallas = jops.flash_attention(*js, block_q=64, block_kv=64, **kw)
    oracle = jref.flash_attention_ref(*js, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **_tol(bf16))


@pytest.mark.parametrize("b,t,s,h,hk,d", [
    (1, 128, 128, 2, 2, 64),
    (2, 256, 256, 4, 2, 64),
    (1, 200, 264, 4, 1, 32),  # ragged
    (2, 64, 512, 8, 4, 128),  # cross lengths
])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_matches_pallas_sweep(b, t, s, h, hk, d, bf16):
    js, ts = _qkv(b, t, s, h, hk, d, seed=t + d, bf16=bf16)
    _check_flash(js, ts, bf16, causal=True)


@pytest.mark.parametrize("window,softcap,causal", [
    (64, None, True), (-1, 50.0, True), (32, 30.0, True), (-1, None, False),
])
def test_flash_attention_matches_pallas_masks(window, softcap, causal):
    js, ts = _qkv(2, 192, 192, 4, 2, 64, seed=3, bf16=False)
    _check_flash(js, ts, False, causal=causal, window=window,
                 softcap=softcap)


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_gemma_heads_ragged(bf16):
    """gemma2's head layout (GQA 8/4, dh 256), a window and the softcap
    at a ragged T, with gemma's query scale."""
    js, ts = _qkv(1, 100, 100, 8, 4, 256, seed=5, bf16=bf16)
    _check_flash(js, ts, bf16, causal=True, window=24, softcap=50.0,
                 scale=1.0 / 16.0)


def test_flash_attention_wrapper_defaults_and_devices():
    _, ts = _qkv(1, 9, 9, 2, 1, 8, seed=1, bf16=False)
    before = ops.LAUNCHES["flash_attention"]
    torch.testing.assert_close(
        ops.flash_attention(*ts),
        ref.flash_attention_ref(*ts, scale=8 ** -0.5), rtol=0, atol=0)
    meta = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_attention(meta, meta, meta)
    assert ops.LAUNCHES["flash_attention"] == before  # no launch on the CPU


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("zc", [False, True])
def test_rmsnorm_matches_jax(zc):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    want = jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x), zero_centered=zc)
    got = L.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), zero_centered=zc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert L.rmsnorm_init(4)["scale"].tolist() == [1.0] * 4


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_jax(fraction):
    jcfg = dataclasses.replace(jgemma.smoke_config(), rope_fraction=fraction)
    cfg = dataclasses.replace(gemma2_2b.smoke_config(),
                              rope_fraction=fraction)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) + 100, (2, 1))
    want = jlm.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = lm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- the model on bridged weights --------------------------------------------


def _dense_configs():
    """A dense config that takes every branch gemma2 does not: QK-norm,
    partial RoPE, minicpm's residual scale, logit divisor and embedding
    scale, SwiGLU, an untied head; global attention."""
    kw = dict(name="dense-smoke", n_layers=3, d_model=48, n_heads=4,
              n_kv_heads=2, d_head=12, d_ff=96, vocab=64, padded_vocab=64,
              rope_fraction=0.5, qk_norm=True, embed_scale=12.0,
              residual_scale=1.4 / 40 ** 0.5, logit_divisor=2.5,
              tie_embeddings=False, dtype="float32")
    return (jlm.LMConfig(**kw, remat=False, fsdp=False),
            lm.LMConfig(**kw))


CONFIGS = {
    "gemma2": lambda: (jgemma.smoke_config(), gemma2_2b.smoke_config()),
    "dense": _dense_configs,
}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcfg, cfg = CONFIGS[request.param]()
    jp = jlm.init(jax.random.PRNGKey(3), jcfg)
    like = lm.init(torch.Generator().manual_seed(0), cfg)
    tp = bridge.from_numpy_tree(_np_tree(jp), like=like, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 24)) \
        .astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _n_leaves(tree):
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def test_bridge_carries_the_stacked_tree(pair):
    _, cfg, jp, tp, _ = pair
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == _n_leaves(tp)
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["layers"]["wq"].shape == (cfg.n_layers, cfg.d_model, cfg.d_q)


def test_forward_matches_jax(pair):
    jcfg, cfg, jp, tp, toks = pair
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got = lm.forward(tp, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill 24 tokens into a 32-position cache (padding and, for
    gemma2, window 8 both bite), then 4 greedy decode steps."""
    jcfg, cfg, jp, tp, toks = pair
    jl, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), max_len=32)
    tl, tc = lm.prefill(tp, cfg, torch.from_numpy(toks), max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert tc["length"] == int(jc["length"]) == 24
    assert tc["k"].shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                             cfg.d_head)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        assert tc["length"] == int(jc["length"]) == 25 + step
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)


def test_decode_step_equals_prefill_of_one_more_token(pair):
    """The serve-path identity the card checks at 32k: decoding token
    T+1 after prefill(T) gives prefill(T+1)'s last logits."""
    _, cfg, _, tp, toks = pair
    t = torch.from_numpy(toks)
    _, cache = lm.prefill(tp, cfg, t[:, :-1], max_len=32)
    got, _ = lm.decode_step(tp, cfg, t[:, -1], cache)
    want, _ = lm.prefill(tp, cfg, t, max_len=32)
    torch.testing.assert_close(got, want, **F32_TOL)


def _bf16_pair():
    """gemma2 smoke widths in bf16 (the cells' compute dtype), the port's
    weights cast once from JAX's f32 ``lm.init`` leaves."""
    jcfg = dataclasses.replace(jgemma.smoke_config(), dtype="bfloat16")
    cfg = dataclasses.replace(gemma2_2b.smoke_config(), dtype="bfloat16")
    jp = jlm.init(jax.random.PRNGKey(4), jcfg)
    like = lm.init(torch.Generator().manual_seed(0), cfg)
    tp = lm.cast_params(bridge.from_numpy_tree(_np_tree(jp), like=like,
                                               device="cpu"), torch.bfloat16)
    return jcfg, cfg, jp, tp


BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def test_bf16_forward_matches_jax():
    """bf16 rounds at other places in the two frameworks."""
    jcfg, cfg, jp, tp = _bf16_pair()
    assert tp["layers"]["ln_attn"]["scale"].dtype == torch.float32
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 20))
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = lm.forward(tp, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_bf16_prefill_and_decode_match_jax():
    """The cells' path in bf16: prefill 20 tokens into a 32-position
    cache (window 8 bites), then 4 decode steps on JAX's greedy tokens;
    logits and cache within the bf16 tolerance."""
    jcfg, cfg, jp, tp = _bf16_pair()
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 20)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), max_len=32)
    tl, tc = lm.prefill(tp, cfg, torch.from_numpy(toks), max_len=32)
    assert tl.dtype == tc["k"].dtype == torch.bfloat16
    for step in range(5):
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), **BF16_TOL)
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc)
    assert tc["length"] == int(jc["length"]) == 24
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32),
                                   **BF16_TOL)


def test_moe_config_builds_but_its_ffn_waits():
    """The MoE FFN is ported (ROADMAP queue A item 16): a MoE config's
    forward runs, is finite, and its loss carries a positive router
    aux."""
    cfg = lm.LMConfig(name="moe-smoke", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=1, d_head=8, d_ff=32, vocab=32,
                      padded_vocab=32, dtype="float32",
                      moe=lm.MoEConfig(n_experts=4, top_k=2, d_expert=8))
    p = lm.init(torch.Generator().manual_seed(0), cfg)
    assert p["layers"]["w1"].shape == (1, 4, 16, 8)
    toks = torch.arange(8, dtype=torch.int64).reshape(2, 4)
    out = lm.forward(p, cfg, toks)
    assert out.shape == (2, 4, 32) and torch.isfinite(out).all()
    with torch.no_grad():
        _, aux = lm._hidden(p, cfg, toks)
    assert float(aux) > 0
    assert cfg.n_active_params() < cfg.n_params()


def test_window_zero_is_refused():
    with pytest.raises(ValueError, match="window of 0"):
        dataclasses.replace(gemma2_2b.smoke_config(), window_pattern=(0,))


@pytest.mark.parametrize("window", [-1, 3])
def test_attn_mask_matches_jax(window):
    q_pos, k_pos = np.arange(5, 9), np.arange(0, 9)
    want = jlm._attn_mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                          jnp.int32(window))
    got = lm._attn_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                        window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- configs, counts, registry, cells and the CLI -----------------------------


def test_configs_mirror_jax():
    for fn in ("full_config", "smoke_config"):
        a = dataclasses.asdict(getattr(jgemma, fn)())
        b = dataclasses.asdict(getattr(gemma2_2b, fn)())
        assert {k: v for k, v in a.items() if k in b} == b, fn
    assert gemma2_2b.SHAPES == jgemma.SHAPES
    assert set(gemma2_2b.SKIPPED_SHAPES) == {"long_500k"}
    assert base.LM_SHAPES == jbase.LM_SHAPES


def test_counts_match_jax():
    for jc, c in ((jgemma.full_config(), gemma2_2b.full_config()),
                  (jgemma.smoke_config(), gemma2_2b.smoke_config()),
                  _dense_configs()):
        assert c.n_params() == jc.n_params()
        assert c.n_active_params() == jc.n_active_params()
        for decode in (False, True):
            assert lm.flops_per_token(c, 4096, decode=decode) == \
                jlm.flops_per_token(jc, 4096, decode=decode)
    assert gemma2_2b.full_config().n_params() == 2_614_341_888
    np.testing.assert_allclose(
        lm.rope_freqs(gemma2_2b.full_config()).numpy(),
        np.asarray(jlm.rope_freqs(jgemma.full_config())), rtol=1e-6)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_model_flops_match_the_jax_cells(shape):
    """meta["model_flops"] counts what the JAX cell counts (at the JAX
    batch; the port's cells cut only the batch)."""
    info = jbase.LM_SHAPES[shape]
    jcell = jbase._lm_cell_raw("gemma2-2b", jgemma.full_config(), shape)
    assert base.lm_model_flops(gemma2_2b.full_config(), info["kind"],
                               info["batch"], info["seq"]) == \
        jcell.meta["model_flops"]


def test_init_is_seeded_and_shaped():
    cfg = gemma2_2b.smoke_config()
    a = lm.init(torch.Generator().manual_seed(1), cfg)
    b = lm.init(torch.Generator().manual_seed(1), cfg)
    for k in ("wq", "wo", "w1"):
        torch.testing.assert_close(a["layers"][k], b["layers"][k], rtol=0,
                                   atol=0)
    assert a["embed"].shape == (128, 64)
    assert a["layers"]["ln_attn_post"]["scale"].shape == (2, 64)
    std = float(a["layers"]["w1"].std())
    assert 0.015 < std < 0.025


def test_registry_returns_gemma_and_names_what_waits():
    assert get_arch("gemma2-2b") is gemma2_2b
    # the MoE archs are ported (ROADMAP queue A item 16)
    for arch, name in (("granite-moe-1b-a400m", "granite_moe_1b_a400m"),
                       ("olmoe-1b-7b", "olmoe_1b_7b")):
        assert get_arch(arch).__name__ == f"repro_torch.configs.{name}"
        with pytest.raises(NotImplementedError, match="full-attention"):
            get_arch(arch).make_cell("long_500k")
    for arch in ("glm4-9b", "minicpm-2b", "gemma2-2b",
                 "granite-moe-1b-a400m", "olmoe-1b-7b"):
        mod = get_arch(arch)
        assert mod.ARCH_ID == arch and mod.FAMILY == "lm"
        # train_4k is ported (ROADMAP queue A item 25): B = 8 of 4,096
        cell = mod.make_cell("train_4k")
        assert cell.kind == "train" and cell.meta["batch"] == 8
        assert cell.meta["seq"] == 4096 and cell.meta["n_microbatches"] == 2
    with pytest.raises(NotImplementedError, match="item 18"):
        gemma2_2b.make_cell("long_500k")


def test_full_cells_are_cut_in_batch_only():
    for shape, batch in (("prefill_32k", 4), ("decode_32k", 8)):
        cell = gemma2_2b.make_cell(shape)
        assert (cell.meta["batch"], cell.meta["seq"]) == (batch, 32768)
        assert cell.kind == shape.split("_")[0]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_cells_at_smoke_widths(shape):
    cfg = gemma2_2b.smoke_config()
    cell = gemma2_2b.make_cell(shape, cfg=cfg)
    args = cell.make_args(0, "cpu")
    out = cell.fn(*args)
    assert out.shape == (gemma2_2b.SMOKE_BATCH, cfg.padded_vocab)
    assert torch.isfinite(out).all()
    if shape == "decode_32k":
        assert args[2]["length"] == gemma2_2b.SMOKE_SEQ - 1
        again = cell.fn(*args)  # the same state: the call repeats
        torch.testing.assert_close(again, out, rtol=0, atol=0)
    torch.testing.assert_close(cell.fn(*cell.make_args(0, "cpu")), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_cells_cli_runs_the_lm_on_the_cpu(capsys, shape):
    from repro_torch.launch import cells

    assert cells.main(["--arch", "gemma2-2b", "--shape", shape,
                       "--preset", "smoke", "--device", "cpu",
                       "--calls", "2"]) == 0
    out = capsys.readouterr().out
    assert f"gemma2-2b x {shape}" in out and out.count("checksum") == 2
    assert "logits (2, 128)" in out
