"""Multi-process serving on the port, on the CPU: gloo groups of child
processes (``tests/torch_mh_child.py``, which import only ``torch`` and
``repro_torch``, one torch thread each) against the one-process run.

The shard count is held at S = 8 in every run, as
``tests/test_multihost.py`` holds it: bitwise parity across process
counts holds only at a fixed S, since the cross-shard sums fold in shard
order.  The gates:

  * the plain stream over 2 and 4 processes and the geotenants stream
    over 2 equal the one-process S = 8 run bit for bit on every host:
    prices, spends and the (tenant, region) spends; the hosts' rows
    stitch to its decisions and serving regions;
  * elastic resume: 2 processes serve windows 0-2 and checkpoint, 4
    resume at window 3, and one process resumes the same checkpoint;
    both equal the uninterrupted run bit for bit;
  * every host has zero steady-state captures;
  * ``ordered_psum`` across processes equals the one-process fold;
  * the CLI over two processes (``--processes 2``) equals ``--shards 2``
    in one process in every window's price and spend, each host writing
    its own suffixed flight log.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_mh_child as child

from torch_system import one_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    first = [child.start(1, "plain,geotenants,psum", tmp, "ref"),
             child.start(2, "plain,geotenants,a,psum", tmp, "p2")]
    ref, p2 = (child.finish(g) for g in first)
    second = [child.start(4, "plain,b,psum", tmp, "p4"),
              child.start(1, "b", tmp, "down")]
    p4, down = (child.finish(g) for g in second)
    return {"ref": ref[0], "p2": p2, "p4": p4, "down": down}


@pytest.mark.parametrize("group", ["p2", "p4"])
def test_plain_stream_bitwise_over_processes(runs, group):
    hosts = runs[group]
    assert [h["host"]["process_index"] for h in hosts] == list(
        range(len(hosts)))
    for h in hosts:
        assert h["host"]["process_count"] == len(hosts)
        assert h["host"]["global_shards"] == 8
        assert h["host"]["local_shards"] == 8 // len(hosts)
    child.assert_group_matches(runs["ref"], hosts, "plain")


def test_geotenants_bitwise_over_two_processes(runs):
    child.assert_group_matches(runs["ref"], runs["p2"], "geotenants")
    assert any(len(set(w["regions"])) > 1
               for w in runs["ref"]["jobs"]["geotenants"]["windows"])


def test_elastic_resume_2_to_4_to_1(runs):
    assert all(len(h["jobs"]["a"]["windows"]) == 3 for h in runs["p2"])
    child.assert_group_matches(runs["ref"], runs["p2"], "a", "plain")
    for group in ("p4", "down"):
        assert all(h["jobs"]["b"]["t0"] == 3 for h in runs[group])
        child.assert_group_matches(runs["ref"], runs[group], "b", "plain",
                                   ref_offset=3)


def test_every_host_zero_steady_captures(runs):
    hosts = [runs["ref"], *runs["p2"], *runs["p4"], *runs["down"]]
    for h in hosts:
        for job, d in h["jobs"].items():
            if "steady_compiles" in d:
                assert d["steady_compiles"] == 0, (h["host"], job)
                assert sum(d["compiles"]) > 0


def test_truncation_held_at_per_shard_rows(runs):
    """Every host held the truncation to its plain version and to the
    revenue it served at its per-shard rows: b / 8 of the plain stream's
    buckets 64, 192 and 96, one check a local shard a bucket."""
    for h in [runs["ref"], *runs["p2"], *runs["p4"]]:
        rows = h["jobs"]["plain"]["truncation_rows"]
        assert sorted(set(rows)) == [8, 12, 24], h["host"]
        assert len(rows) == 4 * h["host"]["local_shards"], h["host"]


def test_ordered_psum_across_processes(runs):
    parts = np.stack([child.shard_partials(s) for s in range(8)])
    want = parts[0]
    for p in parts[1:]:
        want = (want + p).astype(np.float32)
    for h in [runs["ref"], *runs["p2"], *runs["p4"]]:
        got = h["jobs"]["psum"]
        assert got["sum"] == want.astype(np.float64).tolist()
        np.testing.assert_array_equal(np.asarray(got["all"], np.float32),
                                      parts)


def _flight_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_two_processes_equal_two_shards(tmp_path, one_thread):
    """``--processes 2`` against ``--shards 2``: the same trained stack
    (the experiment cache, built by the first run), every window's price
    and spend equal in both hosts' flight logs."""
    from repro_torch.launch import serve

    argv = ["--small", "--device", "cpu", "--source", "generated",
            "--windows", "3", "--requests", "64", "--users", "2000"]
    one = str(tmp_path / "one.prom")
    assert serve.main([*argv, "--shards", "2", "--metrics-out", one]) == 0
    port = child.free_port()
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    two = str(tmp_path / "two.prom")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--processes", "2", "--process-id", str(r), "--coordinator",
         f"127.0.0.1:{port}", "--metrics-out", two],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
        assert "[serve] multihost: {'process_index'" in o
    want = _flight_log(one + ".windows.jsonl")
    for h in range(2):
        got = _flight_log(f"{two}.host{h}.windows.jsonl")
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["host"] == f"host{h}"
            assert (g["lam"], g["spend"], g["budget"]) == (
                w["lam"], w["spend"], w["budget"])
        assert os.path.exists(f"{two}.host{h}")
