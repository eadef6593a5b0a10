"""Tracing pillar: nested, thread-safe spans with device-sync-aware
timing.

Mirrors ``src/repro/obs/trace.py``:

    with obs.span("protocol.run", impl="dense") as sp:
        out = sp.sync(engine_dispatch(...))   # registered for sync

At span exit the registered values are walked (tensors, tuples, lists,
dicts, dataclasses) and ``torch.cuda.synchronize`` runs once for each
distinct CUDA device among them before the clock is read, so
``dur_us`` measures device work, not just the launch queue.  CPU
tensors need nothing.  Pass ``sync=False`` (or register nothing) for
async paths where blocking would serialize a pipeline.

Spans nest per-thread via a thread-local stack; completed spans append
to one process-global record list exported as JSONL (``save_trace``) or
rendered as an indented tree (``format_tree``).  With
``obs.configure(profiler=True)`` each span also enters a
``torch.profiler.record_function`` so it lines up with the kernels in a
profiler trace; ``profile_trace(logdir)`` wraps a block in
``torch.profiler.profile`` and exports a Chrome trace under ``logdir``.

When telemetry is disabled ``span()`` returns one shared no-op object:
no allocation, no clock read, no lock, no sync.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
from pathlib import Path

import torch

from repro_torch.obs import core

__all__ = ["span", "Span", "trace_records", "clear_trace", "save_trace",
           "load_trace", "format_tree", "profile_trace"]

_records: list[dict] = []
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)


class _NoopSpan:
    """Shared disabled-mode span: every method is a constant no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, value):
        return value

    def note(self, **fields) -> None:
        return None


_NOOP = _NoopSpan()


def _cuda_devices(value, found: set) -> None:
    """Add the CUDA devices of every tensor inside ``value`` to
    ``found``."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), found)


def _synchronize(values: list) -> None:
    found: set = set()
    _cuda_devices(values, found)
    for dev in sorted(found, key=lambda d: d.index or 0):
        torch.cuda.synchronize(dev)


class Span:
    __slots__ = ("name", "meta", "_sync", "_vals", "id", "parent", "depth",
                 "t0", "_annot")

    def __init__(self, name: str, sync: bool | None, meta: dict):
        self.name = name
        self.meta = meta
        self._sync = core.sync_default() if sync is None else sync
        self._vals: list = []
        self._annot = None

    def sync(self, value):
        """Register ``value`` (a tensor, or tuples, lists, dicts and
        dataclasses of them) to be synchronised at span exit; returns it
        unchanged so call sites stay one-liners."""
        if self._sync:
            self._vals.append(value)
        return value

    def note(self, **fields) -> None:
        """Attach metadata to the span record."""
        self.meta.update(fields)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        self.depth = len(stack)
        stack.append(self)
        if core.profiler_annotations():
            self._annot = torch.profiler.record_function(self.name)
            self._annot.__enter__()
        self.t0 = core.now()
        return self

    def __exit__(self, *exc):
        if self._vals:
            _synchronize(self._vals)
        t1 = core.now()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        _tls.stack.pop()
        rec = {
            "name": self.name,
            "id": self.id,
            "parent": self.parent,
            "depth": self.depth,
            "thread": threading.current_thread().name,
            "ts_us": round((self.t0 - core.epoch()) * 1e6, 3),
            "dur_us": round((t1 - self.t0) * 1e6, 3),
        }
        if self.meta:
            rec["meta"] = {k: _jsonable(v) for k, v in self.meta.items()}
        with _lock:
            _records.append(rec)
        return False


def span(name: str, *, sync: bool | None = None, **meta):
    """A timed span context manager (the shared no-op when disabled)."""
    if not core.enabled():
        return _NOOP
    return Span(name, sync, meta)


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "item"):
        try:
            return v.item()
        except (ValueError, RuntimeError, TypeError):
            pass
    return str(v)


def trace_records() -> list[dict]:
    """Snapshot of completed span records (copy; safe to mutate)."""
    with _lock:
        return [dict(r) for r in _records]


def clear_trace() -> None:
    with _lock:
        _records.clear()


def save_trace(path) -> Path:
    """Write completed spans as JSONL (one record per line)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    recs = trace_records()
    with p.open("w") as f:
        for r in recs:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return p


def load_trace(path) -> list[dict]:
    recs = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            recs.append(json.loads(line))
    return recs


def format_tree(records: list[dict] | None = None) -> str:
    """Render spans as an indented tree, one line per span:

        protocol.run                         1234.5us  impl=dense
          signature.accumulate_grams          987.6us
    """
    recs = trace_records() if records is None else list(records)
    if not recs:
        return "(no spans recorded)"
    recs.sort(key=lambda r: (r.get("ts_us", 0.0), r.get("id", 0)))
    by_parent: dict[int, list[dict]] = {}
    ids = {r.get("id") for r in recs}
    for r in recs:
        parent = r.get("parent", 0)
        if parent not in ids:
            parent = 0
        by_parent.setdefault(parent, []).append(r)
    lines: list[str] = []

    def walk(parent: int, indent: int) -> None:
        for r in by_parent.get(parent, []):
            meta = r.get("meta") or {}
            extra = "  " + " ".join(f"{k}={v}" for k, v in meta.items()) \
                if meta else ""
            pad = "  " * indent
            label = f"{pad}{r['name']}"
            lines.append(f"{label:<44s} {r['dur_us']:>12.1f}us{extra}")
            walk(r.get("id", -1), indent + 1)

    walk(0, 0)
    return "\n".join(lines)


class profile_trace:
    """Context manager around ``torch.profiler.profile`` (CPU activity,
    and CUDA where a card is present): spans annotated with
    ``configure(profiler=True)`` and the kernels land in one Chrome
    trace, written to ``<logdir>/trace_<pid>.json`` (``self.path``) at
    exit."""

    def __init__(self, logdir: str):
        self.logdir = str(logdir)
        self.path = Path(self.logdir) / f"trace_{os.getpid()}.json"
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        return False
