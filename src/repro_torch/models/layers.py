"""Shared transformer building blocks, PyTorch port of
``src/repro/models/layers.py``.

Conventions (the reference's):
  * activations run in ``cfg.act_dtype`` (bf16 by default); norms and
    softmax accumulate in fp32;
  * initializers take an explicit ``torch.Generator`` and a fan-in.

JAX promotes mixed operand types in a matrix product (bf16 @ f32 -> f32);
``torch.matmul`` refuses them, so every product of the model zoo goes
through ``mm``, which promotes the same way.  Elementwise ops already
promote alike in both frameworks, Python scalars being weak in both.

On DTensors (a mesh, ``launch/sharding.py``) the reshapes that DTensor
cannot shard as XLA would go through ``split_dim`` / ``merge_last``, and
a block's input is gathered over its sequence once (``gather_inner``,
which ``launch/sharding.py``'s ``interior`` hook applies) before the
products that read it; on plain tensors each is the plain reshape or the
tensor itself.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["mm", "gather_inner", "split_dim", "split_last", "merge_last",
           "split_heads", "pad_heads", "unpad_heads", "merge_heads",
           "replications",
           "paddings", "lookup_rows", "placed_like",
           "rms_norm", "rms_norm_init", "dense_init", "embed_init",
           "trunc_normal", "mlp_init", "mlp_apply", "rope", "gelu"]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion for mixed operands.  A
    DTensor ``a`` sharded on a dim between its first and its last (a
    block's sequence) raises: its caller gathers it once first
    (``gather_inner``), since DTensor flattens such a dim only in some
    versions."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    if _inner_sharded(a):
        raise ValueError(f"mm: the input's placements {a.placements} shard "
                         f"an inner dim of its shape {tuple(a.shape)}; "
                         f"gather it first (gather_inner)")
    return a @ b


def _inner_sharded(x: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(x, DTensor) and x.ndim > 2 and any(
        isinstance(pl, Shard) and 0 < pl.dim < x.ndim - 1
        for pl in x.placements)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with a dim between its first and its last sharded (the
    sequence of a block-boundary activation, sharded over "model"
    between blocks) all-gathered over those dims: the sequence-parallel
    gather of a block's input, made once before the products that read
    it.  A plain tensor, or a DTensor sharded only on its first and last
    dims, is returned as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not _inner_sharded(x):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(pl, Shard) and 0 < pl.dim < x.ndim - 1
        else pl for pl in x.placements])


def placed_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` redistributed to ``x``'s placements where both are DTensors
    and differ: a block's branch output meeting its residual stream
    inside a block (RWKV-6's two adds), as the ``residual`` hook does
    between blocks, so that a partial sum is reduced and the gradient
    comes back in the branch's own placement.  Otherwise ``y``."""
    from torch.distributed.tensor import DTensor

    if isinstance(y, DTensor) and isinstance(x, DTensor) \
            and y.placements != x.placements:
        return y.redistribute(x.device_mesh, x.placements)
    return y


#: The open records by kind: ``replications()`` ("replicated": each
#: gather ``split_dim`` makes) and ``paddings()`` ("padded": each head
#: split ``split_heads`` pads); an entry is appended to every open list
#: of its kind.
_RECORDS: dict[str, list[list]] = {"replicated": [], "padded": []}


@contextlib.contextmanager
def _recording(kind: str):
    rec: list = []
    _RECORDS[kind].append(rec)
    try:
        yield rec
    finally:
        _RECORDS[kind].remove(rec)


def _record(kind: str, entry: dict) -> None:
    for rec in _RECORDS[kind]:
        if entry not in rec:
            rec.append(entry)


def replications():
    """Record the splits that gathered a mesh axis while open: a list of
    ``{"split", "axis", "size", "axis_size"}`` dicts, one a distinct
    split (``launch/dryrun.py`` puts it in its artifact)."""
    return _recording("replicated")


def paddings():
    """Record the head splits that were padded while open
    (``split_heads``): a list of ``{"split", "axis", "size",
    "padded_size", "axis_size"}`` dicts, one a distinct split."""
    return _recording("padded")


def split_dim(x: torch.Tensor, dim: int, *shape: int,
              replicate: str | None = None) -> torch.Tensor:
    """Dim ``dim`` of ``x`` (of size ``prod(shape)``) split into ``shape``
    (heads out of a projection, kv groups out of heads).

    On a DTensor whose ``dim`` is sharded over a mesh axis that does not
    divide ``shape[0]``, DTensor cannot express the split's shards.  A
    split named by ``replicate`` gathers that axis first and records it
    (``replications``): Megatron's KV-head replication (``"kv_heads"``:
    fewer kv heads than tensor-parallel ranks, each rank keeps the kv
    head its query heads read) and RWKV-6's LoRA of its five token-shift
    mixes (``"rwkv_mix_lora"``, 5 x 32 values a token).  Any other such
    split (query heads the axis does not divide) raises ``ValueError``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dim = dim % x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        bad = [i for i, pl in enumerate(x.placements)
               if isinstance(pl, Shard) and pl.dim == dim
               and shape[0] % mesh.size(i)]
        if bad:
            names = mesh.mesh_dim_names or tuple(range(mesh.ndim))
            if replicate is None:
                raise ValueError(
                    f"split_dim: {shape[0]} of {shape} do not divide the "
                    f"{mesh.size(bad[0])}-wide mesh axis "
                    f"{names[bad[0]]!r} that shards dim {dim}")
            for i in bad:
                _record("replicated", {
                    "split": replicate, "axis": str(names[i]),
                    "size": shape[0], "axis_size": mesh.size(i)})
            x = x.redistribute(mesh, [
                Replicate() if i in bad else pl
                for i, pl in enumerate(x.placements)])
    return x.reshape(*x.shape[:dim], *shape, *x.shape[dim + 1:])


def lookup_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens`` (an embedding; the MoE combine's
    expert outputs by slot, and the dispatch's gradient by slot).  A
    sharded DTensor table is looked up as Megatron's vocab-parallel
    embedding: its d dim gathered (the FSDP gather before use), each
    rank's rows of its own vocab shard taken on its local tokens and
    zero elsewhere, then summed over the vocab axes (one rank holds each
    row, so the sum is exact; its backward hands each rank the whole
    gradient)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.distributed import grad_summed, sum_replicated

    if not (isinstance(table, DTensor)
            and any(p.is_shard() for p in table.placements)):
        return table[tokens.long()]
    mesh = table.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in table.placements]
    if want != list(table.placements):
        table = table.redistribute(mesh, want)
    vocab_axes = [i for i, p in enumerate(table.placements)
                  if isinstance(p, Shard)]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_want = [Replicate() if i in vocab_axes or not (
        isinstance(p, Shard) and p.dim == 0) else p
        for i, p in enumerate(tokens.placements)]
    if tok_want != list(tokens.placements):
        tokens = tokens.redistribute(mesh, tok_want)
    coord = mesh.get_coordinate()
    chunk = 0
    for i in vocab_axes:
        chunk = chunk * mesh.size(i) + coord[i]
    rows = table.shape[0] // math.prod(mesh.size(i) for i in vocab_axes)

    groups = [mesh.get_group(i) for i in vocab_axes]
    # the table is replicated over the axes that shard the tokens: its
    # rows' gradient sums over them
    token_groups = [mesh.get_group(i) for i, p in enumerate(tokens.placements)
                    if isinstance(p, Shard)]

    def local_rows(tab, tok):
        tab = grad_summed(tab, token_groups)
        ids = tok.long() - chunk * rows
        mine = (ids >= 0) & (ids < rows)
        got = tab[ids.clamp(0, rows - 1)]
        return sum_replicated(torch.where(mine[..., None], got, torch.zeros(
            (), dtype=got.dtype, device=got.device)), groups)

    from torch.distributed.tensor.experimental import local_map

    out = [Replicate() if i in vocab_axes else p
           for i, p in enumerate(tokens.placements)]
    return local_map(local_rows, out_placements=(tuple(out),),
                     in_placements=(tuple(table.placements),
                                    tuple(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def split_last(x: torch.Tensor, *shape: int,
               replicate: str | None = None) -> torch.Tensor:
    """``split_dim`` of the last dim."""
    return split_dim(x, -1, *shape, replicate=replicate)


class _MergeLast(torch.autograd.Function):
    """The last ``n`` dims merged; the gradient split back by
    ``split_dim``, whose rule a DTensor gradient sharded over the merged
    dim needs."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.split = tuple(x.shape[-n:])
        return x.reshape(*x.shape[:-n], -1)

    @staticmethod
    def backward(ctx, grad):
        return split_last(grad, *ctx.split), None


def merge_last(x: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``x (..., a, b)`` -> ``(..., a * b)``, or the last ``n`` dims
    merged (heads into a projection's input)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _MergeLast.apply(x, n)
    return x.reshape(*x.shape[:-n], -1)


def _head_axes(x: torch.Tensor, dim: int) -> tuple[list[int], int]:
    """The mesh axes that shard dim ``dim`` of a DTensor ``x``, and the
    product of their sizes (``[]`` and 1 for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return [], 1
    axes = [i for i, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and pl.dim == dim]
    return axes, math.prod(x.device_mesh.size(i) for i in axes)


def _local(fn, x: torch.Tensor, placements) -> torch.Tensor:
    """``fn`` on each rank's local shard of ``x``, whose placements are
    ``placements`` before and after (a shape change on dims they leave
    whole)."""
    from torch.distributed.tensor.experimental import local_map

    placements = tuple(placements)
    return local_map(fn, out_placements=(placements,),
                     in_placements=(placements,),
                     device_mesh=x.device_mesh)(x)


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int
                ) -> torch.Tensor:
    """A query projection ``x (..., n_heads * head_dim)`` split into
    ``(..., n_heads, head_dim)`` (``split_last``).

    On a DTensor whose last dim is sharded over mesh axes whose product
    ``w`` does not divide ``n_heads`` (Llama-4-Scout's 40 heads on a
    16-wide "model" axis), the heads are padded with zero heads to the
    next multiple of ``w`` and sharded over those axes, ``n_pad / w``
    heads a rank, none replicated: the projection is gathered over the
    axes, split and padded on every rank, and each rank keeps its own
    heads.  The split is recorded (``paddings``).  Nothing that is saved
    is padded: the padding is made here, from zeros, in each forward;
    ``pad_heads`` pads keys and values to match and ``merge_heads``
    drops the padded heads before the output projection, so a padded
    head adds nothing to an output or to a gradient."""
    from torch.distributed.tensor import Replicate, Shard

    dim = x.ndim - 1
    axes, width = _head_axes(x, dim)
    if n_heads % width == 0:
        return split_last(x, n_heads, head_dim)
    n_pad = -(-n_heads // width) * width
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or tuple(range(mesh.ndim))
    _record("padded", {"split": "q_heads",
                       "axis": ",".join(str(names[i]) for i in axes),
                       "size": n_heads, "padded_size": n_pad,
                       "axis_size": width})
    whole = [Replicate() if i in axes else pl
             for i, pl in enumerate(x.placements)]
    x = _local(lambda t: F.pad(t.reshape(*t.shape[:-1], n_heads, head_dim),
                               (0, 0, 0, n_pad - n_heads)),
               x.redistribute(mesh, whole), whole)
    return x.redistribute(mesh, [Shard(dim) if i in axes else pl
                                 for i, pl in enumerate(whole)])


def pad_heads(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``x (B, S, H, hd)`` with zero heads appended up to ``n_pad``
    (keys and values expanded to the query heads, matched to the
    padding of ``split_heads``); ``x`` itself when it has ``n_pad``.
    Only a DTensor is ever padded, and its heads are whole on every
    rank: a mesh axis that does not divide the query heads does not
    divide the kv heads either, so ``split_dim`` gathered them."""
    n = x.shape[2]
    if n == n_pad:
        return x
    return _local(lambda t: F.pad(t, (0, 0, 0, n_pad - n)), x,
                  x.placements)


def unpad_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``x (B, S, H, hd)`` padded by ``split_heads`` (``H > n_heads``)
    -> its first ``n_heads`` heads, whole on every rank: the heads are
    gathered over the axes that shard them.  The gradient comes back
    through the same gather, zero on the padded heads.  ``x`` itself
    when it has ``n_heads``."""
    from torch.distributed.tensor import Replicate

    if x.shape[2] == n_heads:
        return x
    axes, _ = _head_axes(x, 2)
    whole = [Replicate() if i in axes else pl
             for i, pl in enumerate(x.placements)]
    return _local(lambda t: t[:, :, :n_heads],
                  x.redistribute(x.device_mesh, whole), whole)


def merge_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``x (B, S, H, hd)`` -> ``(B, S, n_heads * hd)`` (``merge_last``),
    the padded heads of ``split_heads`` dropped first (``unpad_heads``)
    and the merged dim sharded over the axes that sharded the heads
    again (a local slice), so that the output projection stays
    tensor-parallel."""
    from torch.distributed.tensor import Shard

    if x.shape[2] == n_heads:
        return merge_last(x)
    axes, _ = _head_axes(x, 2)
    x = merge_last(unpad_heads(x, n_heads))
    return x.redistribute(x.device_mesh, [
        Shard(2) if i in axes else pl for i, pl in enumerate(x.placements)])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: its default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def trunc_normal(gen: torch.Generator, shape, std: float,
                 dtype=torch.float32) -> torch.Tensor:
    """``std`` x a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal(-2, 2)``), drawn on ``gen``'s device by
    inverting the normal CDF of a uniform draw.  The numbers differ from
    JAX's for the same seed; the distribution is the same."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (x * (math.sqrt(2.0) * std)).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32
               ) -> torch.Tensor:
    return trunc_normal(gen, (d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5,
                        dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    return trunc_normal(gen, (vocab, d), d ** -0.5, dtype)


def rms_norm_init(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Feed-forward (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, variant: str = "swiglu",
             dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype)}
    if variant == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp_apply(p, x: torch.Tensor, variant: str = "swiglu") -> torch.Tensor:
    """``p`` holds ``w_up``, ``w_down`` (and ``w_gate`` for SwiGLU)."""
    up = mm(x, p.w_up)
    if variant == "swiglu":
        h = F.silu(mm(x, p.w_gate)) * up
    else:
        h = gelu(up)
    return mm(h, p.w_down)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Apply RoPE.  ``x (..., S, H, hd)``, ``positions (..., S)``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq            # (..., S, half)
    ang = ang[..., None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
