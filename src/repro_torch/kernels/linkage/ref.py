"""Plain PyTorch versions of the linkage kernels.

``linkage_step_ref`` mirrors ``src/repro/kernels/linkage/ref.py``: one
NN-chain step on a similarity-linkage row, a Lance-Williams combination
of the two merging clusters' rows plus a masked first-index argmax.
Similarity semantics (higher = closer), so the linkages are mirrored:

  average : (na * a + nb * b) / (na + nb)
  single  : max(a, b)
  complete: min(a, b)

Passing the same row for ``a`` and ``b`` with unit sizes makes the
update an identity, which is how the chain-extension step reuses it as
a masked argmax.

``nn_chain_ref`` is the whole NN-chain loop of
``src/repro/core/cluster_engine.py::_nn_chain`` as a Python loop over
``linkage_step_ref``: one host round trip per step, so it is the plain
version the persistent kernel is held against, never the CUDA path.

``nn_chain_grouped_ref`` runs ``nn_chain_ref`` on each matrix of a
group axis, the plain version of the grouped kernel.

``nn_chain_cached_ref`` is the plain model of the kernel's bookkeeping:
the same chain, with each live row's nearest neighbour kept in a cache
instead of recomputed at every chain extension.  It is on no path; the
tests hold it to ``nn_chain_ref`` and, with ``verify=True``, hold the
cache to the full argmax after every merge.
"""
from __future__ import annotations

import torch

LINKAGES = ("average", "single", "complete")

_NEG = float("-inf")


def lance_williams(row_a: torch.Tensor, row_b: torch.Tensor,
                   size_a: torch.Tensor, size_b: torch.Tensor,
                   linkage: str) -> torch.Tensor:
    """Combine two clusters' linkage rows (similarity semantics)."""
    if linkage == "average":
        return (size_a * row_a + size_b * row_b) / (size_a + size_b)
    if linkage == "single":
        return torch.maximum(row_a, row_b)
    if linkage == "complete":
        return torch.minimum(row_a, row_b)
    raise ValueError(f"linkage must be one of {LINKAGES}, got {linkage!r}")


def linkage_step_ref(row_a: torch.Tensor, row_b: torch.Tensor, size_a,
                     size_b, mask: torch.Tensor, linkage: str = "average"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(new_row, argmax, max)`` of the masked Lance-Williams update.

    ``row_a``/``row_b`` ``(n,)`` f32, ``size_a``/``size_b`` scalars,
    ``mask (n,)`` bool (or float, kept where > 0.5): dropped entries
    become ``-inf`` and never win.  Ties resolve to the smallest index
    and NaN ranks above every number, as ``torch.argmax`` does.
    """
    keep = mask if mask.dtype == torch.bool else mask > 0.5
    sa = torch.as_tensor(size_a, dtype=row_a.dtype, device=row_a.device)
    sb = torch.as_tensor(size_b, dtype=row_a.dtype, device=row_a.device)
    new = lance_williams(row_a, row_b, sa, sb, linkage)
    new = torch.where(keep, new, torch.full_like(new, _NEG))
    idx = torch.argmax(new).to(torch.int32)
    return new, idx, new[idx]


def max_iterations(n: int) -> int:
    """The NN-chain loop's iteration cap.  Chain similarities never
    decrease, so a finite input needs at most about 4n steps; the cap
    only stops a run on non-finite input."""
    return 4 * n + 8


def nn_chain_ref(s: torch.Tensor, linkage: str = "average"
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NN-chain HAC over a prepared linkage matrix, as a Python loop.

    ``s (n, n)`` f32 with the diagonal at ``-inf``; it is updated in
    place.  Returns ``(merge_rows (n-1, 2) i32, heights (n-1,) f32,
    steps)`` in chain order, where ``steps`` (a 0-dim int32 tensor) is
    the number of merges done: ``n - 1`` unless the input held NaN.
    """
    n = s.shape[0]
    dev = s.device
    size = torch.ones(n, dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    cols = torch.arange(n, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    merges = torch.zeros((max(n - 1, 0), 2), dtype=torch.int32, device=dev)
    heights = torch.zeros((max(n - 1, 0),), dtype=torch.float32, device=dev)
    chain: list[int] = []
    t = it = 0
    while t < n - 1 and it < max_iterations(n):
        if not chain:   # re-seed an empty chain with the smallest live row
            chain.append(int(torch.argmax(alive.to(torch.int8))))
        top = chain[-1]
        prev = chain[-2] if len(chain) >= 2 else chain[0]
        row_top = s[top]
        prev_sim = float(row_top[prev]) if len(chain) >= 2 else _NEG
        _, nn, best = linkage_step_ref(row_top, row_top, one, one,
                                       alive & (cols != top), linkage)
        # prev is top's predecessor, so prev_sim >= best means prev
        # attains top's row max: a reciprocal pair.
        if len(chain) >= 2 and prev_sim >= float(best):
            i, j = min(top, prev), max(top, prev)
            na, nb = size[i].clone(), size[j].clone()
            alive[j] = False
            new_row, _, _ = linkage_step_ref(s[i], s[j], na, nb,
                                             alive & (cols != i), linkage)
            s[i, :] = new_row
            s[:, i] = new_row
            s[j, :] = _NEG
            s[:, j] = _NEG
            size[i] = na + nb
            size[j] = 0.0
            merges[t, 0], merges[t, 1] = i, j
            heights[t] = prev_sim
            t += 1
            del chain[-2:]
        else:
            if len(chain) > n:   # chain buffer full: only non-finite input
                break
            chain.append(int(nn))
        it += 1
    return merges, heights, torch.tensor(t, dtype=torch.int32)


def nn_chain_grouped_ref(s: torch.Tensor, linkage: str = "average"
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The group axis: ``nn_chain_ref`` on each ``s[b]`` of ``s (B, n,
    n)`` (updated in place) -> ``(merge_rows (B, n-1, 2), heights (B,
    n-1), steps (B,))``."""
    b, n = s.shape[:2]
    merges = torch.zeros((b, max(n - 1, 0), 2), dtype=torch.int32,
                         device=s.device)
    heights = torch.zeros((b, max(n - 1, 0)), dtype=torch.float32,
                          device=s.device)
    steps = torch.zeros((b,), dtype=torch.int32, device=s.device)
    for i in range(b):
        merges[i], heights[i], steps[i] = nn_chain_ref(s[i], linkage)
    return merges, heights, steps


def _extension_values(rows: torch.Tensor, linkage: str) -> torch.Tensor:
    """What the chain-extension step ranks: ``lance_williams(r, r, 1, 1)``,
    which is ``r`` except that an average of ``|r| > FLT_MAX / 2``
    overflows to ``+-inf``."""
    one = torch.ones((), dtype=rows.dtype, device=rows.device)
    return lance_williams(rows, rows, one, one, linkage)


def _ranks_first(v, i, bv, bi):
    """``(v, i)`` ranks before ``(bv, bi)`` in argmax order: NaN first,
    then the larger value, then the smaller index (elementwise)."""
    vn, bn = torch.isnan(v), torch.isnan(bv)
    return torch.where(vn != bn, vn,
                       torch.where(~vn & (v != bv), v > bv, i < bi))


def _value_at_least(v, bv):
    """``v`` ranks at or above ``bv`` by value alone (NaN highest)."""
    return torch.isnan(v) | (~torch.isnan(bv) & (v >= bv))


def _nearest(s, alive, rows, linkage):
    """Masked first-index argmax of each row in ``rows`` (live columns
    other than the row itself; an all-``-inf`` row gives index 0)."""
    n = s.shape[0]
    cols = torch.arange(n, device=s.device)
    keep = alive[None, :] & (cols[None, :] != rows[:, None])
    vals = torch.where(keep, _extension_values(s[rows], linkage),
                       torch.full((), _NEG, device=s.device))
    idx = torch.argmax(vals, dim=1)
    return vals.gather(1, idx[:, None])[:, 0], idx


def nn_chain_cached_ref(s: torch.Tensor, linkage: str = "average",
                        verify: bool = False):
    """``nn_chain_ref``'s chain with cached nearest neighbours.

    Keeps ``(nnv[c], nni[c])``, the masked first-index argmax of every live
    row's extension values, so that a chain extension reads the cache and
    no row.  A merge of ``(i, j)`` into ``i`` writes the new row and column
    ``i`` at live columns only (dead entries are never read again), sets
    row ``i``'s cache from the new row, and updates every other live row
    ``c`` against its new value ``e`` at column ``i``:

    * ``nni[c]`` not in ``{i, j}``: ``i`` takes over where ``(e, i)`` ranks
      before ``(nnv[c], nni[c])``;
    * ``nni[c]`` in ``{i, j}``: ``i`` where ``e`` ranks at or above
      ``nnv[c]`` (``i < j``, so no other column ties ahead of it), else
      row ``c`` is rescanned.

    ``s`` is updated in place.  Returns ``(merge_rows, heights, steps,
    stats)`` with ``nn_chain_ref``'s first three, and ``stats`` holding
    the loop's ``iterations`` and the ``rescans`` done.  ``verify=True``
    recomputes every live row's argmax after each merge and raises
    ``AssertionError`` where the cache differs from it.
    """
    n = s.shape[0]
    dev = s.device
    size = torch.ones(n, dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    cols = torch.arange(n, device=dev)
    merges = torch.zeros((max(n - 1, 0), 2), dtype=torch.int32, device=dev)
    heights = torch.zeros((max(n - 1, 0),), dtype=torch.float32, device=dev)
    nnv, nni = _nearest(s, alive, cols, linkage)
    chain: list[int] = []
    t = it = rescans = 0
    while t < n - 1 and it < max_iterations(n):
        if not chain:
            chain.append(int(torch.argmax(alive.to(torch.int8))))
        top = chain[-1]
        prev = chain[-2] if len(chain) >= 2 else chain[0]
        prev_sim = float(s[top, prev]) if len(chain) >= 2 else _NEG
        if len(chain) >= 2 and prev_sim >= float(nnv[top]):
            i, j = min(top, prev), max(top, prev)
            alive[j] = False
            keep = alive & (cols != i)
            new = lance_williams(s[i], s[j], size[i], size[j], linkage)
            s[i, keep] = new[keep]
            s[keep, i] = new[keep]
            ext = torch.where(keep, _extension_values(new, linkage),
                              torch.full((), _NEG, device=dev))
            k_i = torch.argmax(ext)
            live = keep.clone()
            old_v, old_k = nnv[live], nni[live]
            e = ext[live]
            idx_i = torch.full_like(old_k, i)
            at_ij = (old_k == i) | (old_k == j)
            take = torch.where(at_ij, _value_at_least(e, old_v),
                               _ranks_first(e, idx_i, old_v, old_k))
            nnv[live] = torch.where(take, e, old_v)
            nni[live] = torch.where(take, idx_i, old_k)
            redo = cols[live][at_ij & ~take]
            if redo.numel():
                nnv[redo], nni[redo] = _nearest(s, alive, redo, linkage)
                rescans += redo.numel()
            nnv[i], nni[i] = ext[k_i], k_i
            size[i] = size[i] + size[j]
            size[j] = 0.0
            merges[t, 0], merges[t, 1] = i, j
            heights[t] = prev_sim
            t += 1
            del chain[-2:]
            if verify:
                rows = cols[alive]
                want_v, want_k = _nearest(s, alive, rows, linkage)
                same_v = (want_v == nnv[rows]) | (torch.isnan(want_v)
                                                  & torch.isnan(nnv[rows]))
                assert bool(same_v.all() and torch.equal(want_k,
                                                         nni[rows])), \
                    f"cached nearest neighbours differ after merge {t}"
        else:
            if len(chain) > n:
                break
            chain.append(int(nni[top]))
        it += 1
    return (merges, heights, torch.tensor(t, dtype=torch.int32),
            {"iterations": it, "rescans": rescans})
