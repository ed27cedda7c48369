"""One member of a multi-process serving run of the port (or the
one-process reference), on the cheap replay stack of
``tests/test_multihost.py``: random stage scores and clicks for 40 users
and 150 items, the paper-shaped chain space, a small reward model drawn
from a seed, served from a ``TableReplaySource``.

Imports only ``torch`` and ``repro_torch``.  Configured by environment:

  MH_JOBS    comma list of: plain (6 spike-like windows), geotenants (4
             windows, 2 priced tenants x 2 regions), a (plain windows
             0-2, then process 0 writes MH_CKPT), b (restore MH_CKPT and
             serve the rest of the plain stream), psum (the shard-ordered
             sum of per-shard partials across the group);
  MH_SHARDS  the request mesh's shard count (default 8);
  MH_DEVICE  cpu (default) or cuda;
  MH_OUT     where to write the digest JSON;
  GREENFLOW_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID  the group (none:
             one process, serving whole windows without host slices).

The digest holds, per job, every window as this process served it
(``window_digest``), the captures, the kernel launches of the
stream (counted on the card), the per-shard row counts at which the
truncation kernel was held to its plain version (``check_truncation``)
and the host report.
"""
import json
import os
import sys

import numpy as np
import torch

from repro_torch.distributed import multihost as mh

PLAIN_SIZES = [64, 192, 50, 64, 96, 64]
GEO_SIZES = [48, 96, 48, 64]


def build(device):
    from repro_torch.cascade.engine import CascadeServer
    from repro_torch.core.action_chain import (ModelInstance, StageSpec,
                                               generate_action_chains)
    from repro_torch.core.reward_model import (RewardModelConfig,
                                               reward_model_init)
    from repro_torch.data.request_source import TableReplaySource

    rng = np.random.default_rng(0)
    u, i = 40, 150
    scores = {k: rng.normal(size=(u, i)).astype(np.float32)
              for k in ("DSSM", "YDNN", "DIN", "DIEN")}
    clicks = (rng.random((u, i)) < 0.15).astype(np.float32)
    n2 = tuple(int(x) for x in np.linspace(0.2 * i, 0.5 * i, 4))
    n3 = tuple(int(x) for x in np.linspace(8, 0.2 * i, 4))
    chains = generate_action_chains((
        StageSpec("recall", (ModelInstance("DSSM", 13e3),), (i,), 4),
        StageSpec("prerank", (ModelInstance("YDNN", 123e3),), n2, 4),
        StageSpec("rank", (ModelInstance("DIN", 7020e3),
                           ModelInstance("DIEN", 7098e3)), n3, 4),
    ))
    server = CascadeServer(scores, chains, clicks, expose=8, device=device)
    ctx = np.random.default_rng(5).normal(size=(u, 12)).astype(np.float32)
    src = TableReplaySource.from_server(server, ctx, seed=7,
                                        device_tables=False, device=device)
    rcfg = RewardModelConfig(n_stages=3, max_models=2, n_scale_groups=4,
                             d_context=12, d_feature=16, d_hidden=16,
                             d_state=8)
    params = reward_model_init(torch.Generator().manual_seed(0), rcfg,
                               device)
    params["label_norm"] = torch.as_tensor(
        np.linspace(1.0, 3.0, chains.n_chains).astype(np.float32),
        device=device)
    return chains, src, params, rcfg


def pipeline(job, chains, src, params, rcfg, mesh, device):
    """The job's pipeline, sizes and per-window budget and scale traces."""
    from repro_torch.serving.pipeline import ServingPipeline
    from repro_torch.serving.spec import (ConstraintSpec, GlobalAxis,
                                          RegionAxis, TenantAxis)

    if job == "geotenants":
        per = 0.5 * float(chains.costs.max())
        spec = ConstraintSpec([TenantAxis((per * 24, per * 24), priced=True),
                               RegionAxis(2), GlobalAxis(pricing="carbon")])
        bt = [np.concatenate([np.full(2, per * n / 2),
                              np.full(2, 0.6 * per * n)]).astype(np.float32)
              for n in GEO_SIZES]
        st = [np.array([1.0, 1.3], np.float32)] * len(GEO_SIZES)
        pipe = ServingPipeline.from_spec(src.universe, params, rcfg, spec,
                                         mesh=mesh, device=device)
        return pipe, list(GEO_SIZES), bt, st
    budget = 0.5 * float(chains.costs.max()) * 64
    pipe = ServingPipeline(src.universe, params, rcfg, budget, mesh=mesh,
                           device=device)
    return pipe, list(PLAIN_SIZES), None, None


def shard_partials(shard: int) -> np.ndarray:
    """Shard ``shard``'s (3,) partials: magnitudes 1e-3 to 1e7, so the
    order of a sum shows in its last bits."""
    rng = np.random.default_rng(100 + shard)
    return (rng.normal(size=3) * 10.0 ** rng.integers(-3, 8, size=3)
            ).astype(np.float32)


def psum(mesh, device) -> dict:
    """``ordered_psum`` and ``gather_shards`` of this process's shards'
    partials over the group."""
    from repro_torch.distributed.sharding import gather_shards, ordered_psum

    mine = torch.from_numpy(np.stack(
        [shard_partials(s) for s in range(
            mesh.first_shard, mesh.first_shard + mesh.local_shards)]))
    mine = mine.to(device)
    return {"sum": ordered_psum(mine, mesh).cpu().double().tolist(),
            "all": gather_shards(mine, mesh).cpu().double().tolist()}


def check_truncation(pipe, windows) -> list[int]:
    """The truncation kernel at this host's per-shard shapes, held bit for
    bit to its plain version and to the revenue served: for the last
    window of each bucket (whose inputs its program still holds), each
    local shard's b / S rows through ``ops.cascade_truncate`` and
    ``ref.cascade_truncate_ref`` on the same tables, groups, rows and
    n3.  Returns the row counts checked, one a shard."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import mesh_local_shards

    last = {r.bucket: r for r in windows if r.bucket is not None}
    checked = []
    for key, r in last.items():
        w = pipe._programs[key]
        d = r.decisions.long()
        per = d.shape[0] // mesh_local_shards(pipe.mesh)
        for at in range(0, d.shape[0], per):
            args = (w.p, w.ck, pipe._g_of[d[at:at + per]],
                    w.rows[at:at + per], pipe._n3_of[d[at:at + per]])
            got = ops.cascade_truncate(*args, expose=pipe._expose)
            want = ref.cascade_truncate_ref(*args, expose=pipe._expose)
            mask = w.valid[w.lo + at:w.lo + at + per]
            if not torch.equal(got, want):
                raise AssertionError(f"cascade_truncate at {per} rows (bucket "
                                     f"{key}, rows {at}) != its plain version")
            if not torch.equal(got * mask, r.revenue[at:at + per]):
                raise AssertionError(f"bucket {key} rows {at}: the kernel "
                                     f"does not give the revenue served")
            checked.append(per)
    return checked


# -- what each host served ---------------------------------------------------


def window_digest(result) -> dict:
    """One served window as this host saw it, as JSON-ready lists: the
    padded window row of each of its valid rows (``req``), their
    decisions (and serving regions), and the replicated price, spend and
    per-(tenant, region) spend every host agrees on."""
    valid = np.asarray(result.valid) > 0
    if result.rows_global is not None:
        rows = np.asarray(result.rows_global)[valid]
    else:
        rows = np.flatnonzero(valid)
    row = {"req": rows.tolist(),
           "dec": result.decisions_np.tolist(),
           "lam": _flat(result.lam_after),
           "spend": _flat(result.spend)}
    if result.regions is not None:
        row["regions"] = result.regions_np.tolist()
    if result.tr_spend is not None:
        row["tr"] = _flat(result.tr_spend)
    return row


def _flat(x) -> list:
    return np.asarray(x.detach().cpu().numpy(),
                      np.float64).reshape(-1).tolist()


def stitch(digests: list[list[dict]], t: int, key: str) -> np.ndarray:
    """Window t's per-host values of ``key`` -> one vector over the
    window's valid rows in padded row order (the hosts' ``window_digest``
    lists, in any order)."""
    req = np.concatenate([np.asarray(d[t]["req"], np.int64)
                          for d in digests])
    val = np.concatenate([np.asarray(d[t][key]) for d in digests])
    return val[np.argsort(req, kind="stable")]


# -- the launcher side (the tests import these) -----------------------------


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(n_procs: int, jobs: str, tmp, tag: str, *, device: str = "cpu",
          shards: int = 8, ckpt=None) -> list:
    """Start a group of ``n_procs`` children (one: the one-process run,
    no group) serving ``jobs``; returns [(digest path, Popen)]."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = []
    for pid in range(n_procs):
        out = os.path.join(str(tmp), f"mh_{tag}_{pid}.json")
        env = dict(os.environ)
        for k in ("GREENFLOW_COORDINATOR", "GREENFLOW_NUM_PROCESSES",
                  "GREENFLOW_PROCESS_ID"):
            env.pop(k, None)
        env.update({
            "PYTHONPATH": os.path.join(here, "..", "src"),
            "OMP_NUM_THREADS": "1", "MH_JOBS": jobs, "MH_OUT": out,
            "MH_SHARDS": str(shards), "MH_DEVICE": device,
            "MH_CKPT": str(ckpt or os.path.join(str(tmp), "stream.json")),
        })
        if n_procs > 1:
            env.update({"GREENFLOW_COORDINATOR": f"127.0.0.1:{port}",
                        "GREENFLOW_NUM_PROCESSES": str(n_procs),
                        "GREENFLOW_PROCESS_ID": str(pid)})
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def finish(procs: list, timeout: float = 300) -> list[dict]:
    """Wait for a group; every child's digest, in rank order.  A child
    that fails or runs out of time ends the whole group."""
    import time

    digests = []
    t_end = time.monotonic() + timeout
    try:
        for out, p in procs:
            o, _ = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"child {out} failed:\n{o[-4000:]}")
            with open(out) as f:
                digests.append(json.load(f))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return digests


def assert_group_matches(ref: dict, group: list[dict], job: str,
                         ref_job: str | None = None,
                         ref_offset: int = 0) -> None:
    """Every host of ``group`` holds the reference's prices and spends bit
    for bit in every window of ``job``, and their rows stitch to the
    reference's decisions (and regions)."""
    rwins = ref["jobs"][ref_job or job]["windows"]
    digests = [c["jobs"][job]["windows"] for c in group]
    for t in range(len(digests[0])):
        rw = rwins[t + ref_offset]
        for c, d in zip(group, digests):
            for key in ("lam", "spend", "tr"):
                assert d[t].get(key) == rw.get(key), (
                    job, t, key, c["host"]["process_index"])
        for key in ("dec", "regions"):
            if key in rw:
                np.testing.assert_array_equal(
                    stitch(digests, t, key), np.asarray(rw[key]),
                    err_msg=f"{job} window {t} {key}")


def main() -> int:
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_request_mesh
    from repro_torch.serving.stream import run_stream

    device = torch.device(os.environ.get("MH_DEVICE", "cpu"))
    if device.type == "cpu":
        torch.set_num_threads(1)
    dist = mh.initialize()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_request_mesh(int(os.environ.get("MH_SHARDS", "8")))
    chains, src0, params, rcfg = build(device)
    out = {"host": mh.host_report(mesh, device), "jobs": {}}
    for job in os.environ["MH_JOBS"].split(","):
        if job == "psum":
            out["jobs"][job] = psum(mesh, device)
            continue
        pipe, sizes, bt, st = pipeline(job, chains, src0, params, rcfg,
                                       mesh, device)
        src, t0 = src0, 0
        if job == "a":
            sizes = sizes[:3]
        elif job == "b":
            ck = mh.restore_stream(os.environ["MH_CKPT"], pipe)
            t0 = ck.t_next
            src = mh.ShiftedSource(src0, t0)
            sizes = sizes[t0:]
        source = mh.MultihostSource(src, pipe) if dist else src
        if device.type == "cuda":
            torch.cuda.synchronize()
        ops.reset_launches()
        stats = run_stream(pipe, sizes, source, prefetch=0,
                           budget_trace=bt, scale_trace=st)
        launches = dict(ops.LAUNCHES)
        truncation_rows = check_truncation(pipe, stats.windows)
        if job == "a" and mesh.rank == 0:
            mh.checkpoint_stream(os.environ["MH_CKPT"], pipe,
                                 t_next=len(sizes), seed=src.seed)
        out["jobs"][job] = {
            "t0": t0, "steady_compiles": int(stats.steady_compiles),
            "compiles": stats.compiles, "launches": launches,
            "truncation_rows": truncation_rows,
            "windows": [window_digest(r) for r in stats.windows]}
    with open(os.environ["MH_OUT"], "w") as f:
        json.dump(out, f)
    mh.shutdown()
    print("CHILD OK", out["host"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
