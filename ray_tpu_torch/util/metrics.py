"""Application metrics with Prometheus exposition (a copy of
``ray_tpu/util/metrics.py``): ``Counter``/``Gauge``/``Histogram``
feeding a process-wide registry, ``export_prometheus`` text exposition
(format 0.0.4), and the cross-process merge (``snapshot_samples``,
``merge_remote``, ``clear_remote``).  The port's registry is its own:
in a process that also imports the JAX package, the two registries sit
side by side.

Of the JAX package's internal scrape-time samples only the request
ring's ``raytpu_serve_requests{State}`` gauge is kept; the runtime's
task, actor, object-store and cluster gauges read a runtime the port
does not host.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

_TagTuple = Tuple[Tuple[str, str], ...]


def _tag_tuple(tags: Optional[Dict[str, str]],
               default_tags: Dict[str, str],
               tag_keys: Sequence[str]) -> _TagTuple:
    merged = dict(default_tags)
    if tags:
        unknown = set(tags) - set(tag_keys)
        if unknown:
            raise ValueError(
                f"unknown tag keys {sorted(unknown)}; declared {tag_keys}"
            )
        merged.update(tags)
    return tuple(sorted(merged.items()))


class Metric:
    """Base: named metric with declared tag keys (parity:
    ray.util.metrics.Metric)."""

    _type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        import re

        # Prometheus metric-name grammar: [a-zA-Z_:][a-zA-Z0-9_:]*
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name or ""):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys: Tuple[str, ...] = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        _default_registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        unknown = set(tags) - set(self.tag_keys)
        if unknown:
            raise ValueError(
                f"unknown tag keys {sorted(unknown)}; declared {self.tag_keys}"
            )
        self._default_tags = dict(tags)
        return self

    def _samples(self) -> List[Tuple[str, _TagTuple, float, str]]:
        """Sample rows ``(sample_name, tags, value, kind)``.  ``kind``
        is the declared family type (counter|gauge|histogram) carried
        on every row so consumers (the time-series sampler, the
        flight-recorder delta pass, scripts/check_metrics.py) never
        have to re-infer it from ``_bucket``/``_sum``/``_count`` name
        suffixes."""
        raise NotImplementedError


class Counter(Metric):
    """Monotonic counter (parity: ray.util.metrics.Counter)."""

    _type = "counter"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[_TagTuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc requires a non-negative value")
        key = _tag_tuple(tags, self._default_tags, self.tag_keys)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _samples(self):
        with self._lock:
            return [(self.name, k, v, "counter")
                    for k, v in self._values.items()]


class Gauge(Metric):
    """Point-in-time value (parity: ray.util.metrics.Gauge)."""

    _type = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[_TagTuple, float] = {}

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        key = _tag_tuple(tags, self._default_tags, self.tag_keys)
        with self._lock:
            self._values[key] = float(value)

    def _samples(self):
        with self._lock:
            return [(self.name, k, v, "gauge")
                    for k, v in self._values.items()]


class Histogram(Metric):
    """Bucketed distribution (parity: ray.util.metrics.Histogram;
    exposition follows the Prometheus histogram convention:
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""

    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        if not boundaries or any(b <= 0 for b in boundaries) or \
                list(boundaries) != sorted(boundaries):
            raise ValueError("boundaries must be positive and ascending")
        self.boundaries = list(boundaries)
        # per tag-set: [bucket counts..., +Inf count], sum
        self._counts: Dict[_TagTuple, List[int]] = {}
        self._sums: Dict[_TagTuple, float] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = _tag_tuple(tags, self._default_tags, self.tag_keys)
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1)
            )
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def _samples(self):
        out = []
        with self._lock:
            for key, counts in self._counts.items():
                cum = 0
                for b, c in zip(self.boundaries, counts):
                    cum += c
                    out.append((f"{self.name}_bucket",
                                key + (("le", repr(float(b))),), float(cum),
                                "histogram"))
                cum += counts[-1]
                out.append((f"{self.name}_bucket",
                            key + (("le", "+Inf"),), float(cum),
                            "histogram"))
                out.append((f"{self.name}_count", key, float(cum),
                            "histogram"))
                out.append((f"{self.name}_sum", key, self._sums[key],
                            "histogram"))
        return out


class MetricsRegistry:
    """Process-wide metric registry; re-registering a name returns
    samples from the newest instance (parity: OpenCensus view registry
    keyed by view name)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._collisions: List[str] = []

    def register(self, metric: Metric) -> None:
        with self._lock:
            prev = self._metrics.get(metric.name)
            if prev is not None and prev is not metric:
                # Newest instance wins (documented), but a DIFFERENT
                # instance claiming a live name is almost always two
                # modules colliding — remembered so the metrics smoke
                # check (scripts/check_metrics.py) can fail loudly
                # instead of one plane silently shadowing another.
                self._collisions.append(metric.name)
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collisions(self) -> List[str]:
        """Names re-registered by a different Metric instance since the
        last clear()."""
        with self._lock:
            return list(self._collisions)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collisions.clear()
        clear_remote()

    def collect(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())


_default_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _default_registry


# -- cross-process merge ----------------------------------------------------
#
# Other processes observe into their own process-local registry and ship
# their absolute sample state (``snapshot_samples``) to one process,
# which stores the latest snapshot per process here.  export_prometheus
# renders them under a
# ``proc`` label, so one driver scrape shows every process's series —
# the single-scrape-endpoint analogue of Prometheus federation.

_remote_lock = threading.Lock()
_remote_snapshots: Dict[str, list] = {}


def snapshot_samples() -> list:
    """Absolute sample state of every registered metric:
    [(family, type, help,
      [(sample_name, tag_tuple, value, kind), ...]), ...].
    The worker-side half of the cross-process merge.  ``kind`` repeats
    the family type on every sample row so per-sample consumers need no
    suffix inference (snapshots from older processes may still carry
    3-tuples; index access, never unpacking, keeps the merge
    tolerant)."""
    return [(m.name, m._type, m.description, list(m._samples()))
            for m in _default_registry.collect()]


def merge_remote(proc: str, snapshot: list) -> None:
    """Store a worker process's sample snapshot (driver-side half).
    Snapshots are absolute cumulative state, so last-write-wins."""
    with _remote_lock:
        _remote_snapshots[proc] = snapshot


def clear_remote() -> None:
    with _remote_lock:
        _remote_snapshots.clear()


# -- internal scrape-time metrics -------------------------------------------

def _internal_samples() -> List[Tuple[str, str, str, _TagTuple, float]]:
    """(name, type, help, tags, value) computed from live state at
    scrape time: the request rings' counts by lifecycle state.  Guarded
    by sys.modules, so a scrape never imports the serving stack into a
    process that never used it."""
    import sys

    out: List[Tuple[str, str, str, _TagTuple, float]] = []
    reqev = sys.modules.get("ray_tpu_torch.serve.request_events")
    if reqev is not None:
        req_states: Dict[str, int] = {}
        for row in reqev.snapshot_rows():
            st = row.get("state") or "NIL"
            req_states[st] = req_states.get(st, 0) + 1
        for st, n in sorted(req_states.items()):
            out.append(("raytpu_serve_requests", "gauge",
                        "Current number of serving requests by "
                        "lifecycle state.",
                        (("State", st),), float(n)))
    return out


def _escape_label(v: str) -> str:
    """Prometheus text-format label escaping: \\ → \\\\, \" → \\\",
    newline → \\n (exposition format 0.0.4)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: _TagTuple) -> str:
    if not tags:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in tags)
    return "{" + body + "}"


def export_prometheus(include_internal: bool = True) -> str:
    """Prometheus text exposition format 0.0.4 of every registered
    metric (+ internal runtime metrics)."""
    lines: List[str] = []
    declared = set()
    for m in _default_registry.collect():
        declared.add(m.name)
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m._type}")
        for name, tags, value, _kind in m._samples():
            lines.append(f"{name}{_fmt_tags(tags)} {value}")
    with _remote_lock:
        remote = sorted(_remote_snapshots.items())
    for proc, snapshot in remote:
        for fam, typ, help_, samples in snapshot:
            if fam not in declared:
                declared.add(fam)
                lines.append(f"# HELP {fam} {help_}")
                lines.append(f"# TYPE {fam} {typ}")
            for s in samples:
                # proc distinguishes the same series observed by
                # different worker processes (federation's instance
                # label, collapsed into the one driver scrape).  Index
                # access: snapshots may be 3- or 4-tuple vintage.
                sname, value = s[0], s[2]
                tags = tuple(map(tuple, s[1])) + (("proc", proc),)
                lines.append(f"{sname}{_fmt_tags(tags)} {value}")
    if include_internal:
        seen_help = set()
        for name, typ, help_, tags, value in _internal_samples():
            if name not in seen_help:
                seen_help.add(name)
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name}{_fmt_tags(tags)} {value}")
    return "\n".join(lines) + "\n"
