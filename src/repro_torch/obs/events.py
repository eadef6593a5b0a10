"""Events pillar: a structured, append-only event log.

Mirrors ``src/repro/obs/events.py``.  Where spans answer "how long" and
metrics answer "how much", events answer "what happened, in what
order": the membership lifecycle (``seed`` / ``assign_wave`` /
``admit`` / ``evict`` / ``drift_trip`` / ``recluster`` with before/after
label agreement).

Each record carries a process-wide sequence number and a ``t_us``
timestamp relative to the same epoch the trace spans use, so the two
streams interleave on one timeline.  Values are coerced to JSON-able
scalars at emit time (0-dim tensors, on the CPU or a CUDA device, and
numpy scalars via ``.item()``), and the log round-trips through JSONL
(``save_events`` / ``load_events``).
"""
from __future__ import annotations

import itertools
import json
import threading
from pathlib import Path

from repro_torch.obs import core

__all__ = ["event", "events", "clear_events", "save_events", "load_events"]

_events: list[dict] = []
_lock = threading.Lock()
_seq = itertools.count()


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "item"):
        try:
            return v.item()
        except (ValueError, RuntimeError, TypeError):
            # an array or tensor of more than one element
            pass
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def event(kind: str, **fields) -> None:
    """Append one structured event (no-op while disabled)."""
    if not core.enabled():
        return
    rec = {"seq": next(_seq),
           "t_us": round((core.now() - core.epoch()) * 1e6, 3),
           "kind": kind}
    for k, v in fields.items():
        rec[k] = _jsonable(v)
    with _lock:
        _events.append(rec)


def events(kind: str | None = None) -> list[dict]:
    """Snapshot of the event log (optionally filtered by kind)."""
    with _lock:
        recs = [dict(r) for r in _events]
    if kind is not None:
        recs = [r for r in recs if r["kind"] == kind]
    return recs


def clear_events() -> None:
    with _lock:
        _events.clear()


def save_events(path) -> Path:
    """Write the event log as JSONL (one event per line)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    recs = events()
    with p.open("w") as f:
        for r in recs:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return p


def load_events(path) -> list[dict]:
    recs = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            recs.append(json.loads(line))
    return recs
