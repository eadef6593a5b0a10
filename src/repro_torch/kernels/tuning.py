"""Launch plans of the port's kernels: each wrapper's own plan as the
default, plus a measured-sweep autotuner with a persistent on-disk cache.

Mirrors ``src/repro/kernels/tuning.py``.  Where the reference resolves
Pallas tiles, the port resolves the launch plan its wrappers computed
before the tuner existed (``heuristic_blocks``):

  * ``assign_wave`` (bf16, ``assign/ops.py::wave_plan``), ``assign_one``
    (``one_plan``), ``gram_project`` (``gram_project/ops.py::
    project_plan``) and ``linear_scan`` (``recurrent_scan/ops.py::
    linear_scan_plan``) take part of their plan at run time, and resolve
    it through ``get_blocks``;
  * ``gram``, ``eigproject``, ``featurize_gram``, ``linkage``,
    ``flash_attention`` and ``wkv_chunked`` fix their tiles when they are
    compiled: their plan is reported, never tuned.

``get_blocks`` overlays a cache hit on the default, keyed ``kernel |
platform:device kind | shape bucket`` (``gpu:NVIDIA H100 80GB HBM3``, or
``cpu:cpu``), so an entry measured on one device class never replays on
another.  A hit may set only the fields the launch takes at run time
(``RUNTIME_FIELDS``); the wrapper's ``resolve`` then recomputes what
follows from them and raises ``ValueError`` on a plan that does not fit.
Nothing falls back to the default.

The sweep (``autotune``) times caller-supplied candidates and records the
winner.  Set ``REPRO_TORCH_TUNE_CACHE=/path/to/cache.json`` to persist
results across processes (the reference's file, ``REPRO_TUNE_CACHE``,
is never read); without it the sweep caches in memory for the process.
With no entry, every plan is the wrapper's default.

Shape buckets round every dimension up to a power of two, so one sweep
at ``n=2048`` serves ``n in (1025..2048]``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from pathlib import Path
from typing import Callable, Iterable

from repro_torch.kernels import dispatch

__all__ = ["KERNELS", "RUNTIME_FIELDS", "shape_bucket", "cache_key",
           "cache_path", "heuristic_blocks", "get_blocks", "autotune",
           "lookup", "record", "clear_cache", "divisor_block"]

_ENV = "REPRO_TORCH_TUNE_CACHE"
_LANE = 128

#: Kernels the tuner knows a launch plan for (the launch names of
#: ``dispatch.LAUNCHES`` that have one).
KERNELS = ("gram", "eigproject", "linkage", "featurize_gram",
           "gram_project", "assign_wave", "assign_one", "flash_attention",
           "wkv_chunked", "linear_scan")

#: Kernel -> the plan fields a cache hit may set: those the launch takes
#: at run time.  Kernels not listed have no such field.
RUNTIME_FIELDS: dict[str, tuple[str, ...]] = {
    "assign_wave": ("n_slices", "ksteps_per_slice"),
    "assign_one": ("slice_rows", "stages"),
    "gram_project": ("bk", "stages"),
    "linear_scan": ("route",),
}

# In-memory overlay of the on-disk cache (survives the process even when
# REPRO_TORCH_TUNE_CACHE is unset: tuning on without persistence).
_mem: dict[str, dict] = {}
_loaded_from: str | None = None


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def divisor_block(n: int, cap: int = 4096) -> int:
    """Largest lane-multiple block <= ``cap`` that divides ``n`` exactly.
    ``n`` must itself be a lane multiple."""
    if n % _LANE:
        raise ValueError(f"row length {n} is not a lane multiple of {_LANE}")
    for b in range(min(cap, n), _LANE - 1, -_LANE):
        if n % b == 0:
            return b
    return _LANE


def shape_bucket(**dims: int) -> str:
    """Canonical bucket string: dims sorted by name, pow2-ceiled."""
    return ",".join(f"{k}={_pow2_ceil(v)}" for k, v in sorted(dims.items()))


def _backend_tag(device) -> str:
    return f"{dispatch.backend_kind(device)}:{dispatch.device_kind(device)}"


def cache_key(kernel: str, device="cuda", **dims: int) -> str:
    """``kernel|platform:device kind|bucket`` for ``device``."""
    return f"{kernel}|{_backend_tag(device)}|{shape_bucket(**dims)}"


def cache_path() -> Path | None:
    p = os.environ.get(_ENV, "")
    return Path(p) if p else None


def _load_disk() -> None:
    """Merge the on-disk cache under the in-memory overlay (memory wins:
    it holds this process's fresher sweeps)."""
    global _loaded_from
    p = cache_path()
    tag = str(p) if p else None
    if tag == _loaded_from:
        return
    _loaded_from = tag
    if p is None or not p.exists():
        return
    try:
        disk = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return
    for k, v in disk.items():
        _mem.setdefault(k, v)


def _persist() -> None:
    p = cache_path()
    if p is None:
        return
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(_mem, indent=2, sort_keys=True) + "\n")
    tmp.replace(p)


def clear_cache() -> None:
    """Drop the in-memory cache (does not touch the disk file)."""
    global _loaded_from
    _mem.clear()
    _loaded_from = None


def lookup(kernel: str, device="cuda", **dims: int) -> dict | None:
    """Tuned plan fields for this kernel/device class/bucket, or None."""
    _load_disk()
    if not _mem:                # nothing tuned: no key to build
        return None
    hit = _mem.get(cache_key(kernel, device, **dims))
    return dict(hit["blocks"]) if hit else None


def record(kernel: str, blocks: dict, measured_s: float | None = None,
           sweep: dict | None = None, device="cuda", **dims: int) -> None:
    """Store a sweep winner; persists when REPRO_TORCH_TUNE_CACHE is set."""
    entry: dict = {"blocks": dict(blocks)}
    if measured_s is not None:
        entry["measured_s"] = measured_s
    if sweep:
        entry["sweep"] = sweep
    _load_disk()
    _mem[cache_key(kernel, device, **dims)] = entry
    _persist()


# ---------------------------------------------------------------------------
# The wrappers' own plans: the defaults when nothing is cached
# ---------------------------------------------------------------------------

def heuristic_blocks(kernel: str, **dims: int) -> dict:
    """The launch plan the wrapper computes for ``dims``, as a (fresh)
    dict.

    Dims by kernel: ``assign_wave`` b, t, d, sms; ``assign_one`` b, t, d,
    k, sms, itemsize (2 bf16, 4 fp32 compute); ``gram_project`` b, n, d,
    k; ``linear_scan`` b, s, d, aligned (1 or 0); ``gram`` and
    ``eigproject`` d; ``featurize_gram`` d, itemsize; ``linkage`` n;
    ``flash_attention`` hd, itemsize (of q, k, v); ``wkv_chunked`` hd.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}: one of {KERNELS}")
    return dict(_plan(kernel, tuple(sorted(dims.items()))))


@functools.lru_cache(maxsize=1024)
def _plan(kernel: str, items: tuple) -> dict:
    dims = dict(items)
    if kernel == "assign_wave":
        from repro_torch.kernels.assign.ops import wave_plan
        plan = wave_plan(dims["b"], dims["t"], dims["d"], dims["sms"])
    elif kernel == "assign_one":
        from repro_torch.kernels.assign.ops import one_plan
        plan = one_plan(dims["b"], dims["t"], dims["d"], dims["k"],
                        dims["sms"], _compute_dtype(dims["itemsize"]))
    elif kernel == "gram_project":
        from repro_torch.kernels.gram_project.ops import project_plan
        plan = project_plan(dims["d"])
    elif kernel == "linear_scan":
        from repro_torch.kernels.recurrent_scan.ops import linear_scan_plan
        plan = linear_scan_plan(dims["b"], dims["s"], dims["d"],
                                bool(dims["aligned"]))
    elif kernel == "gram":
        from repro_torch.kernels.gram.ops import gram_plan
        plan = gram_plan(dims["d"])
        return {k: v for k, v in dataclasses.asdict(plan).items()
                if k != "pairs"}
    elif kernel == "eigproject":
        from repro_torch.kernels.eigproject.ops import eig_plan
        plan = eig_plan(dims["d"])
    elif kernel == "featurize_gram":
        from repro_torch.kernels.featurize_gram.ops import featurize_plan
        plan = featurize_plan(dims["d"], _compute_dtype(dims["itemsize"]))
    elif kernel == "linkage":
        from repro_torch.kernels.linkage.ops import chain_plan
        plan = chain_plan(dims["n"])
    elif kernel == "flash_attention":
        # csrc/flash_attention_tc.cu (bf16) and flash_attention.cu (fp32):
        # query rows a block, threads a block.
        bf16 = dims["itemsize"] == 2
        return {"kernel": "tc" if bf16 else "fp32",
                "rows": 64 if bf16 else 32, "threads": 128,
                "hd": dims["hd"]}
    else:
        # csrc/recurrent_scan.cu: tokens a sub-chunk, warps a block.
        return {"sub_chunk": 16, "warps": dims["hd"] // 4}
    return dataclasses.asdict(plan)


def _compute_dtype(itemsize: int) -> str:
    if itemsize not in (2, 4):
        raise ValueError(f"itemsize must be 2 (bf16) or 4 (fp32), got "
                         f"{itemsize}")
    return "bf16" if itemsize == 2 else "fp32"


def get_blocks(kernel: str, resolve: Callable[[dict], dict] | None = None,
               device="cuda", **dims: int) -> dict:
    """The resolved launch plan: the wrapper's default overlaid by any
    tuned cache entry for this kernel x device class x shape bucket.

    A hit may set only ``RUNTIME_FIELDS[kernel]``; ``resolve`` (the
    wrapper's) recomputes the fields that follow from them and raises
    ``ValueError`` on a plan that does not fit.  The plan is recorded
    once (``dispatch.record_dispatch``), after it resolved, so the
    wrapper's ``count_launch`` does not record it again.
    """
    blocks = heuristic_blocks(kernel, **dims)
    hit = lookup(kernel, device, **dims)
    if hit:
        extra = set(hit) - set(RUNTIME_FIELDS.get(kernel, ()))
        if extra:
            raise ValueError(f"{kernel}: a cached plan may set only "
                             f"{RUNTIME_FIELDS.get(kernel, ())}, got "
                             f"{sorted(extra)}")
        blocks.update(hit)
        if resolve is not None:
            blocks = resolve(blocks)
    if kernel in dispatch.FAMILIES:
        dispatch.record_dispatch(dispatch.FAMILIES[kernel], blocks)
    return blocks


# ---------------------------------------------------------------------------
# The measured sweep
# ---------------------------------------------------------------------------

def autotune(kernel: str, run: Callable[[dict], None],
             candidates: Iterable[dict], n_iter: int = 3, warmup: int = 1,
             device="cuda", **dims: int) -> dict:
    """Time ``run(blocks)`` over candidate plans, cache the winner.

    ``run`` must execute the kernel end to end and synchronise.
    Candidates that raise ``ValueError`` (a plan that does not fit the
    shape) are skipped.  Returns the winning blocks; the measured sweep is
    recorded under the kernel/device class/bucket cache key and persisted
    when ``REPRO_TORCH_TUNE_CACHE`` is set.
    """
    results: dict[str, float] = {}
    best: tuple[float, dict] | None = None
    for cand in candidates:
        cand = dict(cand)
        try:
            for _ in range(warmup):
                run(cand)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                run(cand)
            dt = (time.perf_counter() - t0) / n_iter
        except ValueError:
            continue
        results[json.dumps(cand, sort_keys=True)] = dt
        if best is None or dt < best[0]:
            best = (dt, cand)
    if best is None:
        raise ValueError(f"no valid tuning candidate for {kernel} {dims}")
    record(kernel, best[1], measured_s=best[0], sweep=results, device=device,
           **dims)
    return best[1]
