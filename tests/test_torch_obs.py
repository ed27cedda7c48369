"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

  * the registry: the same calls give byte-equal Prometheus text and JSON
    snapshots in both packages; a disabled registry hands out shared
    no-op singletons and retains nothing;
  * the tracer: valid Chrome trace-event JSON with a track a thread; with
    ``annotate=True`` every span is also a ``torch.profiler`` range;
    ``merge_chrome_traces`` merges as JAX's does;
  * timing attribution through the port's ``run_stream(clock=...)`` is
    exact, and its per-window metrics snapshot equals the JAX driver's
    for the same fake clock and windows;
  * ``env_info`` records the torch stack, the card only when there is
    one, and no JAX;
  * obs on is bitwise obs off: the plain pipeline (sequential) and the
    geotenants day (prefetch 2) on the small generated world;
  * the JSONL rows of a pinned-price carbon day equal the JAX rows;
  * the CLI's ``--metrics-out``, ``--trace-out`` and ``--profile-dir``
    write their files.
"""
import json
import threading

import numpy as np
import pytest
import torch
import torch_tiny
from torch_system import one_thread  # noqa: F401 (a fixture)

from repro import obs as jobs
from repro.carbon import controller as jctl
from repro.carbon import intensity as jint
from repro.carbon import ledger as jled
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.stream import run_stream as jrun_stream
from repro_torch import obs as tobs
from repro_torch.carbon import controller as tctl
from repro_torch.carbon import intensity as tint
from repro_torch.carbon import ledger as tled
from repro_torch.serving.stream import run_stream as trun_stream

LAM_RTOL = 1e-3

# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def _drive_counters(reg):
    c = reg.counter("greenflow_windows_total", "windows")
    c.inc()
    c.inc(3)
    reg.counter("greenflow_requests_total", "requests").inc(7)
    b = reg.counter("greenflow_bucket_windows_total", "per bucket")
    b.labels(bucket=(64, True)).inc()
    b.labels(bucket=(128, False)).inc(2)


def _drive_gauges(reg):
    g = reg.gauge("greenflow_lambda", unit="1/cost")
    g.labels(axis="tenant[0]").set(1.5e-5)
    g.labels(axis="region_a").set(2.0)
    reg.gauge("greenflow_spend").labels(axis="region_a").set(0.5)
    reg.gauge("greenflow_budget").set(123456789.0)


def _drive_histograms(reg):
    h = reg.histogram("greenflow_prep_ms", "prep", "ms",
                      edges=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 100.0):
        h.observe(v)
    d = reg.histogram("greenflow_stall_ms", "stall", "ms",
                      edges=tobs.MS_EDGES)
    for v in (0.0, 0.25, 7.3, 9000.0):
        d.observe(v)
    reg.histogram("greenflow_window_size").labels(tenant=2).observe(510)


@pytest.mark.parametrize("drive", [_drive_counters, _drive_gauges,
                                   _drive_histograms])
def test_registry_text_and_snapshot_byte_equal_jax(drive):
    regs = [jobs.MetricsRegistry(), tobs.MetricsRegistry()]
    for reg in regs:
        drive(reg)
        drive(reg)  # cached children, repeated labels
    j, t = regs
    assert t.prometheus_text() == j.prometheus_text()
    assert json.dumps(t.snapshot(), indent=2) == json.dumps(j.snapshot(),
                                                            indent=2)
    assert tobs.log2_edges(0.25, 8192.0) == jobs.log2_edges(0.25, 8192.0)
    assert tobs.MS_EDGES == jobs.MS_EDGES


def test_registry_caches_and_refuses_kind_changes():
    reg = tobs.MetricsRegistry()
    a = reg.counter("x_total")
    assert reg.counter("x_total") is a
    assert a.labels(bucket=128) is a.labels(bucket=128)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")


def test_disabled_registry_is_allocation_free():
    """A disabled registry and ``NULL_OBS`` hand out shared stateless
    singletons; driving them over a hot loop retains nothing in the
    obs package."""
    import gc
    import os
    import tracemalloc

    reg = tobs.MetricsRegistry(enabled=False)
    c = reg.counter("greenflow_windows_total")
    h = reg.histogram("greenflow_prep_ms")
    assert c is tobs.NULL_INSTRUMENT and h is tobs.NULL_INSTRUMENT
    assert c.labels(bucket=128) is tobs.NULL_INSTRUMENT
    obs = tobs.get_obs(None)
    assert obs is tobs.NULL_OBS and not obs.enabled
    assert obs.span("prep") is tobs.NULL_SPAN

    def hot():
        for _ in range(2000):
            c.inc()
            c.inc(7)
            h.observe(3.5)
            with obs.span("prep"):
                pass

    hot()
    obs_dir = os.path.dirname(tobs.__file__)
    tracemalloc.start(1)
    gc.collect()
    before = tracemalloc.take_snapshot()
    hot()
    gc.collect()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    retained = sum(s.size_diff for s in after.compare_to(before, "lineno")
                   if s.size_diff > 0
                   and s.traceback[0].filename.startswith(obs_dir))
    assert retained < 4096, retained
    assert obs.tracer.events == []


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------


def test_chrome_trace_schema(tmp_path):
    tracer = tobs.Tracer(process_label="host0")
    with tracer.span("serve", t=0):
        with tracer.span("dispatch", n=128, bucket=(128, False)):
            pass
    tracer.instant("mark", t=1)

    def worker():
        with tracer.span("prep", t=1):
            pass

    th = threading.Thread(target=worker, name="chunk-prefetch")
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    with open(tracer.write(str(tmp_path / "t" / "trace.json"))) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {e["name"] for e in xs} == {"serve", "dispatch", "prep", "mark"}
    for e in xs:
        assert {"name", "ph", "pid", "tid", "ts", "dur", "cat"} <= set(e)
    assert len({e["tid"] for e in xs}) == 2
    assert {"MainThread", "chunk-prefetch", "host0"} <= {
        e["args"]["name"] for e in metas}
    serve = next(e for e in xs if e["name"] == "serve")
    disp = next(e for e in xs if e["name"] == "dispatch")
    assert disp["tid"] == serve["tid"] and serve["ts"] <= disp["ts"]
    assert disp["ts"] + disp["dur"] <= serve["ts"] + serve["dur"]
    assert serve["args"] == {"t": 0}
    assert disp["args"] == {"n": 128, "bucket": [128, False]}
    # merging per-host files: the port's merge is the JAX package's
    other = tobs.Tracer(process_label="host1")
    with other.span("serve"):
        pass
    paths = [str(tmp_path / "t" / "trace.json"),
             other.write(str(tmp_path / "t1.json"))]
    merged = tobs.merge_chrome_traces(paths, str(tmp_path / "m.json"))
    assert merged == jobs.merge_chrome_traces(paths)
    assert json.load(open(tmp_path / "m.json")) == merged


def test_annotated_spans_are_profiler_ranges():
    """``annotate=True`` opens a ``record_function`` range a span, so a
    ``torch.profiler`` trace holds the host spans by name."""
    from torch.profiler import ProfilerActivity, profile

    tracer = tobs.Tracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("dual_update", n=4):
            torch.ones(3).sum()
    names = {e.key for e in prof.key_averages()}
    assert "dual_update" in names
    assert [e[0] for e in tracer.events] == ["dual_update"]


# ---------------------------------------------------------------------------
# Timing attribution and the per-window metrics
# ---------------------------------------------------------------------------


class _FakeResult:
    def __init__(self, n):
        self.prep_ms = self.stall_ms = 0.0
        self.h2d_bytes = 0
        self.compiles = 0
        self.bucket = None
        self.n_valid = n
        self.revenue_np = np.ones(n, np.float32)
        self.lam_after = np.float32(0.5)
        self.spend = np.float32(2.0)
        self.budget = 4.0
        self.k_budget = None
        self.flops = None
        self.downgraded = 0
        self.tr_spend = self.region_spend = self.tenant_spend = None


class _FakePipeline:
    def serve_window(self, ctx, rows, **kw):
        return _FakeResult(len(rows))


def _source(t, n):
    return np.zeros((n, 2), np.float32), np.zeros(n, np.int32)


def test_fake_clock_attribution_and_metrics_equal_jax(capsys):
    """The sequential driver on an injected clock: every prep and
    submit spans one 1 s tick, and the registry's snapshot (windows,
    requests, sizes, prep/stall/submit histograms, h2d, captures) and
    the gauges set after the drain are the JAX driver's, byte for byte,
    but the help text of ``greenflow_compiles_total``, which counts the
    port's graph captures where JAX counts jit cache misses; the live
    line prints every ``interval`` windows."""
    snaps, stats = [], []
    for run, mod in ((trun_stream, tobs), (jrun_stream, jobs)):
        ticks = iter(range(1000))
        obs = mod.Obs(interval=2)
        stats.append(run(_FakePipeline(), [4, 6, 4], _source, prefetch=0,
                         obs=obs, clock=lambda: float(next(ticks))))
        snap = obs.metrics.snapshot()
        snaps.append(snap["greenflow_compiles_total"].pop("help"))
        snaps.append(json.dumps(snap, indent=2))
    assert snaps[0] == "window program captures"
    assert snaps[2] == "jit cache misses"
    snaps = snaps[1::2]
    st, jst = stats
    assert st.prep_ms == [1000.0] * 3 and st.submit_ms == [1000.0] * 3
    assert st.stall_ms == [0.0] * 3 and st.wall_s == 13.0
    for name in ("prep_ms", "submit_ms", "stall_ms", "wall_s"):
        assert getattr(st, name) == getattr(jst, name)
    assert snaps[0] == snaps[1]
    snap = json.loads(snaps[0])
    assert snap["greenflow_requests_total"]["series"][0]["value"] == 14
    assert snap["greenflow_lambda"]["series"] == [
        {"labels": {"axis": "global"}, "value": 0.5}]
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if ln.startswith("[obs] w=")]
    assert len(lines) == 4 and lines[:2] == lines[2:]  # windows 0 and 2


def test_env_info_records_the_torch_stack(monkeypatch):
    from repro_torch.obs import env

    info = env.env_info()
    assert isinstance(info["cpu_count"], int) and "timestamp_utc" in info
    assert info["torch"] == torch.__version__
    assert "cuda" in info and "git_sha" in info
    assert not any(k.startswith("jax") for k in info)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    off = env.env_info()
    assert not {"device_kind", "n_devices", "card"} & set(off)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "H")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(env, "card_line", lambda: "H, 700.00 W")
    on = env.env_info()
    assert (on["device_kind"], on["n_devices"], on["card"]) == (
        "H", 1, "H, 700.00 W")
    assert set(on) - set(off) == {"device_kind", "n_devices", "card"}


# ---------------------------------------------------------------------------
# Obs on is obs off, bit for bit
# ---------------------------------------------------------------------------

FIELDS = ("decisions", "revenue", "spend", "downgraded", "flops",
          "lam_before", "lam_after", "tenant_spend", "regions",
          "region_spend", "tr_spend")


def _assert_bitwise(a, b):
    assert len(a.windows) == len(b.windows)
    for t, (x, y) in enumerate(zip(a.windows, b.windows)):
        for name in FIELDS:
            u, v = getattr(x, name), getattr(y, name)
            assert (u is None) == (v is None), (t, name)
            assert u is None or torch.equal(u, v), (t, name)


def _stack(scenario, obs=None):
    from repro_torch.launch import serve

    return serve.build_stack(users=2000, requests=48, windows=3,
                             scenario=scenario, small=True, tenants=3,
                             obs=obs, device="cpu")


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def test_obs_on_equals_off_plain(tmp_path):
    """The plain pipeline, sequentially: telemetry on equals off bit for
    bit; the flight log holds a row a window, the registry the windows,
    requests and the cache counters the source's ints."""
    from repro_torch.launch import serve

    obs = tobs.Obs(events=tobs.WindowEventLog(str(tmp_path / "w.jsonl")))
    off, on = _stack("spike"), _stack("spike", obs)
    a = serve.serve(off, prefetch=0)
    b = serve.serve(on, prefetch=0, obs=obs)
    _assert_bitwise(a, b)
    rows = _rows(obs.events.path)
    assert [r["n"] for r in rows] == on.sizes
    assert rows[0]["lam"].keys() == {"global"} == rows[0]["spend"].keys()
    assert [r["bucket"] for r in rows] == [list(w.bucket)
                                           for w in b.windows]
    snap = obs.metrics.snapshot()

    def value(name):
        return snap[name]["series"][0]["value"]

    assert value("greenflow_windows_total") == len(on.sizes)
    assert value("greenflow_requests_total") == sum(on.sizes)
    assert value("greenflow_compiles_total") == sum(b.compiles)
    assert value("greenflow_table_cache_misses_total") == \
        on.source.cache_misses > 0
    names = {e[0] for e in obs.tracer.events}
    assert {"prep", "serve", "h2d", "dispatch", "dual_update",
            "block_until_ready", "chunk_tables"} <= names
    assert "stall" not in names  # the sequential path never waits


def test_obs_on_equals_off_geotenants_prefetched(tmp_path):
    """The CLI's geotenants day (3 priced tenants x 2 regions) with
    prefetch 2: telemetry on equals off bit for bit; the rows name every
    constraint axis, the producer thread is a track of its own, the
    price gauges carry every axis."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args([
        "--scenario", "geotenants", "--windows", "3", "--requests", "48",
        "--tenants", "3", "--tenant-mode", "priced", "--prefetch", "2",
        "--carbon-report", str(tmp_path / "geo.csv")])
    off = serve.region_day(_stack("geotenants"), args)
    obs = tobs.Obs(events=tobs.WindowEventLog(str(tmp_path / "g.jsonl")))
    on = serve.region_day(_stack("geotenants", obs), args, obs=obs)
    _assert_bitwise(off.stats, on.stats)
    cs = on.pipeline._cs
    rows = _rows(obs.events.path)
    assert len(rows) == 3
    assert list(rows[-1]["lam"]) == list(cs.k_names)
    assert list(rows[-1]["budget"]) == list(cs.budget_names)
    assert rows[-1]["budget"]["tenant[0]"] == pytest.approx(
        float(on.budgets[-1][0]))
    trace = obs.tracer.chrome_trace()
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M"}
    assert {"chunk-prefetch", "MainThread"} <= tracks
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"prep", "serve", "h2d", "dispatch", "dual_update", "stall",
            "block_until_ready", "chunk_tables"} <= spans
    snap = obs.metrics.snapshot()
    assert {s["labels"]["axis"] for s in
            snap["greenflow_lambda"]["series"]} == set(cs.k_names)
    assert {s["labels"]["name"] for s in
            snap["greenflow_gco2e_total"]["series"]} == {"region_a",
                                                         "region_b"}


# ---------------------------------------------------------------------------
# The flight log against the JAX package's
# ---------------------------------------------------------------------------


def test_jsonl_rows_equal_jax(tmp_path):
    """A diurnal carbon day under flops pricing on the tiny stack, the
    port fed the JAX reward matrix at the JAX run's entry prices, each
    pipeline with its own package's ledger and flight log, both drivers
    on the same fake clock: every row's key and value equal the JAX
    row's, but ``bucket`` (the port's program key), ``compiles``
    (captures, not jit misses) and ``h2d_bytes`` (each package's own
    uploads: the port copies int64 rows and its knobs vector through
    pinned buffers), and the published price within 1e-3 relative."""
    stack = torch_tiny.build(pow2=True)
    n_w, n = 5, 64
    flops = 0.3 * float(stack.jchains.costs.max()) * n
    wins = torch_tiny.windows(n_w, n=n, seed=5)
    rows, lam_trace = [], None
    for pkg in ("jax", "torch"):
        ctl, itn, led, obs_mod = ((jctl, jint, jled, jobs) if pkg == "jax"
                                  else (tctl, tint, tled, tobs))
        cb = ctl.CarbonBudget.from_flops(flops, itn.diurnal_trace(),
                                         window_s=86400.0 / n_w)
        ledger = led.CarbonLedger(
            stack.jchains if pkg == "jax" else stack.tchains, cb.trace,
            window_s=cb.window_s)
        obs = obs_mod.Obs(events=obs_mod.WindowEventLog(
            str(tmp_path / f"{pkg}.jsonl")))
        ticks = iter(range(1000))
        kw = dict(budget_trace=cb.schedule(n_w)["flops_budget"],
                  prefetch=0, obs=obs, clock=lambda: float(next(ticks)))
        if pkg == "jax":
            pipe = JPipeline(stack.jserver, stack.jparams, stack.jrcfg,
                             flops, ledger=ledger, obs=obs)
            st = jrun_stream(pipe, [n] * n_w, lambda t, m: wins[t], **kw)
            lam_trace = [np.asarray(w.lam_before) for w in st.windows]
        else:
            pipe = torch_tiny.FedPipeline(stack, flops, ledger=ledger,
                                          obs=obs)
            trun_stream(pipe, [n] * n_w, lambda t, m: wins[t],
                        lam_trace=lam_trace, **kw)
        rows.append(_rows(obs.events.path))
    jrows, trows = rows
    assert len(trows) == len(jrows) == n_w
    for j, t in zip(jrows, trows):
        assert set(t) == set(j)
        for key in set(j) - {"bucket", "compiles", "h2d_bytes", "lam"}:
            assert t[key] == j[key], key
        assert t["lam"].keys() == j["lam"].keys()
        np.testing.assert_allclose(t["lam"]["global"], j["lam"]["global"],
                                   rtol=LAM_RTOL)
        assert t["gco2e"] > 0 and t["bucket"] == [n, False]
    assert sum(r["downgraded"] for r in trows) > 0


# ---------------------------------------------------------------------------
# The CLI's telemetry flags
# ---------------------------------------------------------------------------


def test_cli_writes_metrics_trace_and_profile(tmp_path, capsys, one_thread):
    from repro_torch.launch import serve

    prom = tmp_path / "m" / "serve.prom"
    trace = tmp_path / "serve.trace.json"
    prof = tmp_path / "prof"
    assert serve.main(["--small", "--device", "cpu", "--source",
                       "generated", "--scenario", "constant", "--windows",
                       "2", "--requests", "32", "--users", "2000",
                       "--metrics-out", str(prom), "--trace-out",
                       str(trace), "--profile-dir", str(prof),
                       "--obs-interval", "1"]) == 0
    out = capsys.readouterr().out
    assert "[obs] w=0" in out and "[obs] w=1" in out
    text = prom.read_text()
    assert "greenflow_windows_total 2" in text.splitlines()
    snap = json.loads((tmp_path / "m" / "serve.prom.json").read_text())
    assert snap["greenflow_requests_total"]["series"][0]["value"] == 64
    assert len(_rows(str(prom) + ".windows.jsonl")) == 2
    spans = {e["name"] for e in json.loads(trace.read_text())[
        "traceEvents"] if e["ph"] == "X"}
    assert {"serve", "dispatch", "dual_update"} <= spans
    prof_doc = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in prof_doc["traceEvents"]}
    assert {"serve", "dispatch", "window/main"} <= names
