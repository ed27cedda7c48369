"""Low-overhead metrics registry: counters, gauges, log2 histograms.

The JAX package's registry, copied: the same calls give the same
Prometheus text and JSON snapshot, byte for byte.  Pure Python,
designed around two hot-path facts of the serving loop:

  * ENABLED instruments are bound once (``counter(...)`` /
    ``instrument.labels(...)`` return cached children) and updated with
    one attribute add under a per-instrument lock - a handful of
    sub-microsecond operations per WINDOW (never per request).
  * A DISABLED registry hands out ONE shared null instrument whose
    methods are argument-swallowing no-ops: the hot path performs no
    allocations, takes no locks, and touches no shared state.  The
    zero-overhead test in tests/test_torch_obs.py pins this.

Label support is positional-free: ``labels(bucket=..., axis=...)``
keys a child by the sorted (key, value) tuple, so ``tenant``/``region``
/``axis``/``bucket`` attributions share one metric name (the Prometheus
convention).  Histograms use FIXED log2 bucket edges chosen at
registration - observation is a bisect over a small tuple, no
allocation, no dynamic bucketing.

Exporters: ``prometheus_text`` (text exposition format v0.0.4) and
``snapshot`` (a JSON-able dict, one entry per metric, each with its
type/help/unit and every labeled child's value).
"""
from __future__ import annotations

import threading
from bisect import bisect_left


def log2_edges(lo: float, hi: float) -> tuple[float, ...]:
    """Fixed histogram edges: powers of two from ``lo`` up to >= ``hi``
    (plus the implicit +Inf overflow bucket)."""
    edges = []
    e = float(lo)
    while e < hi:
        edges.append(e)
        e *= 2.0
    edges.append(e)
    return tuple(edges)


class _NullInstrument:
    """The shared no-op instrument of a disabled registry.

    Every mutation method swallows its arguments and returns
    immediately; ``labels`` returns the same singleton, so bound
    children are free too.  Stateless and therefore trivially safe to
    share across threads.
    """

    __slots__ = ()

    def labels(self, **kv) -> "_NullInstrument":
        return self

    def inc(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass


NULL_INSTRUMENT = _NullInstrument()


class _Child:
    """One labeled series of an instrument (the unlabeled series is the
    child with an empty label tuple)."""

    __slots__ = ("parent", "key", "value", "bucket_counts", "sum")

    def __init__(self, parent, key):
        self.parent = parent
        self.key = key  # sorted ((label, value), ...) tuple
        self.value = 0.0
        if parent.kind == "histogram":
            self.bucket_counts = [0] * (len(parent.edges) + 1)
            self.sum = 0.0

    def inc(self, amount=1):
        with self.parent.lock:
            self.value += amount

    def set(self, value):
        with self.parent.lock:
            self.value = float(value)

    def observe(self, value):
        v = float(value)
        i = bisect_left(self.parent.edges, v)
        with self.parent.lock:
            self.bucket_counts[i] += 1
            self.value += 1  # observation count
            self.sum += v

    def labels(self, **kv):  # re-labeling a child refines its key
        return self.parent.labels(**dict(self.key), **kv)


class Instrument:
    """A named metric: a family of labeled ``_Child`` series."""

    __slots__ = ("name", "kind", "help", "unit", "edges", "lock",
                 "children")

    def __init__(self, name: str, kind: str, help: str = "",
                 unit: str = "", edges: tuple[float, ...] = ()):
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.edges = tuple(float(e) for e in edges)
        self.lock = threading.Lock()
        self.children: dict[tuple, _Child] = {}

    def labels(self, **kv) -> _Child:
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        child = self.children.get(key)
        if child is None:
            with self.lock:
                child = self.children.get(key)
                if child is None:
                    child = _Child(self, key)
                    self.children[key] = child
        return child

    # unlabeled convenience: instrument IS its default child
    def inc(self, amount=1):
        self.labels().inc(amount)

    def set(self, value):
        self.labels().set(value)

    def observe(self, value):
        self.labels().observe(value)


class MetricsRegistry:
    """The one namespace every serving metric registers under.

    ``MetricsRegistry(enabled=False)`` is the zero-overhead form: every
    ``counter``/``gauge``/``histogram`` call returns the shared
    ``NULL_INSTRUMENT`` and nothing is ever recorded.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._instruments: dict[str, Instrument] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str, unit: str,
             edges: tuple[float, ...] = ()):
        if not self.enabled:
            return NULL_INSTRUMENT
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = Instrument(name, kind, help, unit, edges)
                    self._instruments[name] = inst
        if inst.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{inst.kind}, not {kind}")
        return inst

    def counter(self, name: str, help: str = "", unit: str = ""):
        return self._get(name, "counter", help, unit)

    def gauge(self, name: str, help: str = "", unit: str = ""):
        return self._get(name, "gauge", help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  edges: tuple[float, ...] = ()):
        return self._get(name, "histogram", help, unit,
                         edges or log2_edges(1.0, 4096.0))

    # -- export ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view: {metric: {type, help, unit, series: [...]}}.
        Histogram series carry bucket edge -> cumulative count pairs."""
        out = {}
        for name, inst in sorted(self._instruments.items()):
            series = []
            with inst.lock:
                children = list(inst.children.items())
            for key, child in sorted(children):
                entry = {"labels": dict(key), "value": child.value}
                if inst.kind == "histogram":
                    cum, buckets = 0, {}
                    for e, c in zip(inst.edges, child.bucket_counts):
                        cum += c
                        buckets[f"{e:g}"] = cum
                    buckets["+Inf"] = cum + child.bucket_counts[-1]
                    entry.update(count=int(child.value), sum=child.sum,
                                 buckets=buckets)
                series.append(entry)
            out[name] = {"type": inst.kind, "help": inst.help,
                         "unit": inst.unit, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every registered metric."""
        lines = []
        for name, m in self.snapshot().items():
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
            for s in m["series"]:
                lab = _fmt_labels(s["labels"])
                if m["type"] == "histogram":
                    for edge, cum in s["buckets"].items():
                        le = _fmt_labels({**s["labels"], "le": edge})
                        lines.append(f"{name}_bucket{le} {cum}")
                    lines.append(f"{name}_sum{lab} {s['sum']:g}")
                    lines.append(f"{name}_count{lab} {s['count']}")
                else:
                    lines.append(f"{name}{lab} {s['value']:g}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


NULL_REGISTRY = MetricsRegistry(enabled=False)
