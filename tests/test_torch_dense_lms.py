"""glm4-9b and minicpm-2b: the JAX package's dense LM configs on the port,
on the CPU.

At ``smoke_config()`` (f32) on JAX ``lm.init`` weights carried over by
the bridge, the port's ``prefill`` logits and cache and a decode step
are held to the JAX LM's within 1e-5.  glm4 takes partial RoPE and an
untied head; minicpm its embedding scale, depth-scaled residuals and
logit divisor, with MHA (kv = heads).  The configs, parameter and FLOP
counts mirror the JAX package; the cells keep every width and cut only
the batch (glm4: prefill B = 4, decode B = 32; minicpm: B = 4 both); the
cells run at smoke widths and through the cells CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import glm4_9b as jglm4
from repro.configs import minicpm_2b as jminicpm
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import base, get_arch, glm4_9b, minicpm_2b
from repro_torch.models import lm
from torch_parity import F32_TOL, np_tree

ARCHS = {"glm4-9b": (jglm4, glm4_9b), "minicpm-2b": (jminicpm, minicpm_2b)}
CUT = {"glm4-9b": {"prefill_32k": 4, "decode_32k": 32},
       "minicpm-2b": {"prefill_32k": 4, "decode_32k": 4}}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    jmod, mod = ARCHS[request.param]
    jcfg, cfg = jmod.smoke_config(), mod.smoke_config()
    jp = jlm.init(jax.random.PRNGKey(3), jcfg)
    like = lm.init(torch.Generator().manual_seed(0), cfg)
    tp = bridge.from_numpy_tree(np_tree(jp), like=like, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 24)) \
        .astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def test_forward_matches_jax(pair):
    jcfg, cfg, jp, tp, toks = pair
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got = lm.forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill 24 tokens into a 32-position cache, then decode steps on
    JAX's greedy tokens: logits and cache within 1e-5."""
    jcfg, cfg, jp, tp, toks = pair
    jl, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), max_len=32)
    tl, tc = lm.prefill(tp, cfg, torch.from_numpy(toks), max_len=32)
    assert tl.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    for step in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        assert tc["length"] == int(jc["length"]) == 25 + step
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)


def test_decode_step_equals_prefill_of_one_more_token(pair):
    """The identity the card checks at full width, at smoke widths."""
    _, cfg, _, tp, toks = pair
    t = torch.from_numpy(toks)
    _, cache = lm.prefill(tp, cfg, t[:, :-1], max_len=32)
    got, _ = lm.decode_step(tp, cfg, t[:, -1], cache)
    want, _ = lm.prefill(tp, cfg, t, max_len=32)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_and_counts_mirror_jax(arch):
    jmod, mod = ARCHS[arch]
    for fn in ("full_config", "smoke_config"):
        a = dataclasses.asdict(getattr(jmod, fn)())
        b = dataclasses.asdict(getattr(mod, fn)())
        assert {k: v for k, v in a.items() if k in b} == b, fn
        jc, c = getattr(jmod, fn)(), getattr(mod, fn)()
        assert c.n_params() == jc.n_params()
        for decode in (False, True):
            assert lm.flops_per_token(c, 4096, decode=decode) == \
                jlm.flops_per_token(jc, 4096, decode=decode)
    assert mod.SHAPES == jmod.SHAPES
    assert set(mod.SKIPPED_SHAPES) == {"long_500k"}
    assert mod.SKIPPED_SHAPES["long_500k"] == jmod.SKIPPED_SHAPES["long_500k"]
    assert get_arch(arch) is mod
    want = {"glm4-9b": 9_399_767_040, "minicpm-2b": 2_725_173_504}[arch]
    assert mod.full_config().n_params() == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_full_cells_cut_the_batch_only(arch, shape):
    """The batch cut of the config module's docstring, every width kept,
    and model_flops as the JAX cell counts them at the JAX batch."""
    jmod, mod = ARCHS[arch]
    cell = mod.make_cell(shape)
    assert (cell.meta["batch"], cell.meta["seq"]) == (CUT[arch][shape],
                                                      32768)
    assert cell.kind == shape.split("_")[0]
    info = jbase.LM_SHAPES[shape]
    jcell = jbase._lm_cell_raw(arch, jmod.full_config(), shape)
    assert base.lm_model_flops(mod.full_config(), info["kind"],
                               info["batch"], info["seq"]) == \
        jcell.meta["model_flops"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_cells_at_smoke_widths(arch, shape):
    _, mod = ARCHS[arch]
    cfg = mod.smoke_config()
    cell = mod.make_cell(shape, cfg=cfg)
    args = cell.make_args(0, "cpu")
    out = cell.fn(*args)
    assert out.shape == (base.LM_SMOKE_BATCH, cfg.padded_vocab)
    assert torch.isfinite(out).all()
    if shape == "decode_32k":
        assert args[2]["length"] == base.LM_SMOKE_SEQ - 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cells_cli_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import cells

    assert cells.main(["--arch", arch, "--shape", "prefill_32k", "--preset",
                       "smoke", "--device", "cpu", "--calls", "1"]) == 0
    out = capsys.readouterr().out
    assert f"{arch} x prefill_32k" in out and out.count("checksum") == 1
