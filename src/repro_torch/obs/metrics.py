"""Metrics pillar: a process-global registry of counters, gauges and
histograms, snapshotable to JSON and diffable between snapshots.

Mirrors ``src/repro/obs/metrics.py``: the same keys, the same
``name{k=v,...}`` label folding and the same pow-2 histogram buckets.
``count("kernel_calls", kernel="assign")`` lands under
``kernel_calls{kernel=assign}``.  The registry is guarded by one lock;
every mutator is a no-op (zero registry mutation) while telemetry is
disabled.

Stack-wide metrics fed from the instrumented hot paths:

  ``dispatch_count`` / ``kernel_calls{kernel=..}`` / ``kernel_blocks``
      from ``kernels/dispatch.record_dispatch``, which
      ``dispatch.count_launch`` calls where a wrapper launches its CUDA
      kernel (labelled by the reference's tuning family); the plain
      versions on the CPU launch nothing and record nothing.
  ``retrace_count``
      counts compiles.  The reference counts jit cache misses through
      ``jax.monitoring``; the only compile the port does at run time is
      ``kernels/build.py::build``, the ``nvcc`` build of the kernel
      library.  ``install_retrace_hook`` registers a listener there:
      each finished build counts one while telemetry is on, and a stamp
      hit (a finished build reused) counts nothing.  The name stays, so
      ``stamp()`` keeps the reference's three keys.
  ``assign_latency_us`` / ``directory_bytes`` / ``unassigned_frac`` /
  ``recluster_events``
      from ``MembershipEngine``.
  ``comm_upload_bytes`` + the full ``comm.*`` mirror
      fed straight from ``CommLedger.summary()`` via ``record_ledger``.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

from repro_torch.obs import core

__all__ = ["count", "gauge", "observe", "counter_value", "counter_total",
           "gauge_value", "snapshot", "diff", "clear_metrics",
           "save_snapshot", "load_snapshot", "record_ledger", "stamp",
           "install_retrace_hook"]

_lock = threading.RLock()
_counters: dict[str, float] = {}
_gauges: dict[str, float | str] = {}
_hists: dict[str, dict] = {}

_hook_installed = False


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def count(name: str, n: float = 1, **labels) -> None:
    """Increment a monotonic counter (no-op while disabled)."""
    if not core.enabled():
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0) + n


def gauge(name: str, value, **labels) -> None:
    """Set a last-value-wins gauge (numbers or short strings)."""
    if not core.enabled():
        return
    k = _key(name, labels)
    if hasattr(value, "item"):
        value = value.item()
    with _lock:
        _gauges[k] = value


def observe(name: str, value: float, **labels) -> None:
    """Record one histogram observation (pow-2 buckets)."""
    if not core.enabled():
        return
    value = float(value)
    k = _key(name, labels)
    le = 1 << max(0, int(value) - 1).bit_length() if value > 1 else 1
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = {"count": 0, "total": 0.0,
                             "min": value, "max": value, "buckets": {}}
        h["count"] += 1
        h["total"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)
        b = str(le)
        h["buckets"][b] = h["buckets"].get(b, 0) + 1


def counter_value(name: str, default: float = 0, **labels) -> float:
    with _lock:
        return _counters.get(_key(name, labels), default)


def counter_total(name: str) -> float:
    """Sum of a counter over all its label sets."""
    prefix = name + "{"
    with _lock:
        return sum(v for k, v in _counters.items()
                   if k == name or k.startswith(prefix))


def gauge_value(name: str, default=None, **labels):
    with _lock:
        return _gauges.get(_key(name, labels), default)


def snapshot() -> dict:
    """JSON-able snapshot of the whole registry."""
    with _lock:
        return {
            "counters": dict(_counters),
            "gauges": dict(_gauges),
            "histograms": {
                k: {**{kk: vv for kk, vv in h.items() if kk != "buckets"},
                    "mean": (h["total"] / h["count"] if h["count"] else 0.0),
                    "buckets": dict(h["buckets"])}
                for k, h in _hists.items()},
        }


def diff(before: dict, after: dict) -> dict:
    """Delta between two ``snapshot()`` dicts: counter increments, gauge
    transitions and histogram count/total growth (zero deltas elided)."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    keys = set(before.get("counters", {})) | set(after.get("counters", {}))
    for k in sorted(keys):
        d = (after.get("counters", {}).get(k, 0)
             - before.get("counters", {}).get(k, 0))
        if d:
            out["counters"][k] = d
    bg, ag = before.get("gauges", {}), after.get("gauges", {})
    for k in sorted(set(bg) | set(ag)):
        if bg.get(k) != ag.get(k):
            out["gauges"][k] = [bg.get(k), ag.get(k)]
    bh, ah = before.get("histograms", {}), after.get("histograms", {})
    for k in sorted(set(bh) | set(ah)):
        b = bh.get(k, {"count": 0, "total": 0.0})
        a = ah.get(k, {"count": 0, "total": 0.0})
        dc = a["count"] - b["count"]
        if dc:
            out["histograms"][k] = {"count": dc,
                                    "total": a["total"] - b["total"]}
    return out


def clear_metrics() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()


def save_snapshot(path) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(snapshot(), indent=2, sort_keys=True) + "\n")
    return p


def load_snapshot(path) -> dict:
    return json.loads(Path(path).read_text())


def record_ledger(ledger) -> None:
    """Mirror a ``CommLedger.summary()`` into ``comm.*`` gauges, plus the
    headline ``comm_upload_bytes`` total (all users' protocol uploads)."""
    if not core.enabled():
        return
    s = ledger.summary()
    for k, v in s.items():
        if v is None:
            continue
        gauge(f"comm.{k}", v)
    gauge("comm_upload_bytes", s["per_user_upload_bytes"] * s["n_users"])


def stamp() -> dict:
    """The small metrics stamp benchmarks attach next to their
    environment stamp: dispatch/retrace counters + enablement."""
    return {
        "obs_enabled": core.enabled(),
        "dispatch_count": counter_total("dispatch_count"),
        "retrace_count": counter_total("retrace_count"),
    }


def _on_build(_path) -> None:
    if core.enabled():
        count("retrace_count")


def install_retrace_hook() -> None:
    """Count kernel-library builds as ``retrace_count``.

    Registers a listener with ``kernels/build.py``, called after every
    finished ``nvcc`` build (never on a stamp hit).  Idempotent; the
    listener stays registered and gates on ``core.enabled()`` when it
    fires, so a build while telemetry is off counts nothing.
    """
    global _hook_installed
    if _hook_installed:
        return
    from repro_torch.kernels import build

    build.add_build_listener(_on_build)
    _hook_installed = True
