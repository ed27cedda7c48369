"""The paper's offline experiment built by the port alone, on the CPU.

One port-only build at the ``system_exp`` config of ``tests/conftest.py``
(800 users, 200 items, histories of 10, world seed 3; cascade 120 steps,
reward model 300, batch 48), with the port's own inits: the claims of
``tests/test_system.py`` hold on it as they do on the JAX package's
build.  (The card runs the same build in ``chip_smoke.py`` phase 9b.)
Then ``build_serving_stack`` and its experiment cache at a tiny size.

Torch runs on one thread here: these are thousands of small ops, which
eight threads a process (times the test workers) make several times
slower.
"""
import numpy as np
import pytest
import torch

from repro_torch import experiments as E
from repro_torch.data.synthetic import WorldConfig


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SYSTEM_CFG = E.ExperimentConfig(
    world=WorldConfig(n_users=800, n_items=200, hist_len=10, seed=3),
    expose=8, n_scales=4, cascade_steps=120, reward_steps=300, batch=48)


@pytest.fixture(scope="module")
def exp(one_thread):
    return E.build_experiment(SYSTEM_CFG, device="cpu")


@pytest.fixture(scope="module")
def reward(exp):
    return E.train_reward_model(exp)


def test_build_trained_every_model(exp):
    assert set(exp.history) == {"DSSM", "YDNN", "DIN", "DIEN"}
    assert len(exp.history["DIN"]) == 2 * len(exp.history["YDNN"]) == 240
    for name, losses in exp.history.items():
        assert np.isfinite(losses).all(), name
        assert np.mean(losses[-20:]) < np.mean(losses[:20]), name
    for tree in (exp.models.din_params, exp.models.ydnn_params):
        assert not any(p.requires_grad for p in E.leaves(tree))


def test_revenue_matrix_sane(exp):
    assert exp.revenue_eval.shape[1] == exp.chains.n_chains
    assert (exp.revenue_eval >= 0).all()
    assert exp.revenue_eval.max() <= exp.cfg.expose
    assert exp.revenue_eval.mean() > 0.05


def test_more_compute_helps_on_average(exp):
    order = np.argsort(exp.chains.costs)
    assert exp.revenue_eval[:, order[-10:]].mean() > \
        exp.revenue_eval[:, order[:10]].mean()


def test_oracle_beats_equal_everywhere(exp):
    for row in E.evaluate_methods(exp, budgets_frac=(0.4, 0.6, 0.8)):
        assert row["oracle"] >= max(row["equal_din"], row["equal_dien"])
        assert row["oracle_spend"] <= row["budget_flops"] * 1.001


def test_greenflow_budget_feasible_and_competitive(exp, reward):
    params, rcfg = reward
    pred = E.predicted_rewards(exp, params, rcfg, exp.ctx_eval)
    for row in E.evaluate_methods(exp, budgets_frac=(0.4, 0.6, 0.8),
                                  rewards_pred=pred):
        assert row["greenflow_spend"] <= row["budget_flops"] * 1.001
        best_equal = max(row["equal_din"], row["equal_dien"])
        assert row["greenflow"] >= best_equal * 0.95, row


def test_greenflow_beats_equal_at_mid_budget(exp, reward):
    params, rcfg = reward
    pred = E.predicted_rewards(exp, params, rcfg, exp.ctx_eval)
    row = E.evaluate_methods(exp, budgets_frac=(0.5,), rewards_pred=pred)[0]
    assert row["greenflow"] >= max(row["equal_din"], row["equal_dien"])


def test_reward_model_beats_constant_predictor(exp, reward):
    params, rcfg = reward
    m = E.reward_model_metrics(exp, params, rcfg)
    const_mse = float(np.mean(
        (exp.revenue_eval - exp.revenue_reward.mean()) ** 2))
    assert m["mse"] < const_mse
    assert np.isfinite(m["field_rce"])


def test_cras_runs_and_respects_budget(exp):
    stage = E.cras_stage_rewards(exp)
    for row in E.evaluate_methods(exp, budgets_frac=(0.3, 0.6),
                                  stage_rewards=stage):
        for key in ("cras_din", "cras_dien", "cras_both"):
            assert row[key] > 0


def test_serving_stack_and_its_cache(tmp_path, monkeypatch, one_thread):
    """``build_serving_stack`` at a tiny size: the server serves the eval
    users, and a second call loads the experiment from the cache (models
    back on the device, the same arrays)."""
    monkeypatch.setattr(E, "CACHE", str(tmp_path))
    cfg = E.ExperimentConfig(
        world=WorldConfig(n_users=120, n_items=60, hist_len=6, seed=4),
        expose=4, n_scales=3, cascade_steps=3, reward_steps=3, batch=16)
    exp, server, params, rcfg = E.build_serving_stack(cfg, device="cpu")
    assert len(list(tmp_path.iterdir())) == 1
    n = len(exp.split.final_eval)
    for j in (exp.chains.cheapest(), exp.chains.most_expensive()):
        dec = np.full(n, j, np.int32)
        rev, _ = server.serve(np.arange(n), dec)
        np.testing.assert_array_equal(rev,
                                      exp.revenue_eval[np.arange(n), dec])
    again, _, params2, _ = E.build_serving_stack(cfg, device="cpu")
    np.testing.assert_array_equal(again.revenue_eval, exp.revenue_eval)
    assert torch.equal(again.models.din_params["attn"]["layers"][0]["w"],
                       exp.models.din_params["attn"]["layers"][0]["w"])
    assert torch.equal(params2["label_norm"], params["label_norm"])
