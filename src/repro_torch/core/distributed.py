"""Multi-device one-shot protocol over ``torch.distributed``.

PyTorch port of ``src/repro/core/distributed.py``, and the collective
pieces the port's sharded paths share.  The reference runs its
``shard_map`` backends on one process over a mesh of devices; here they
are SPMD code: one process a device, joined in a ``torch.distributed``
process group (NCCL for CUDA devices, gloo for the CPU), with a 1-D
``DeviceMesh`` naming the axis users (or clusters) are sharded over.
Every rank calls the same entry point with the same arguments; each
works on its own slice of the sharded axis, and the paper's messages
become ``all_gather`` (signatures, relevance rows, affinity columns) and
``all_reduce`` (the GPS average) on the axis's group.

``distributed_similarity`` keeps the reference's call signature.
``run_ranks`` starts the processes of such a program on one host.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

__all__ = ["make_user_mesh", "axis_group", "check_backend", "local_rows",
           "all_gather_cat", "distributed_similarity", "run_ranks",
           "sum_replicated", "grad_summed", "BACKEND_FOR"]

#: The collective backend each device type takes.
BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def make_user_mesh(axis_name: str = "data", device_type: str | None = None):
    """A 1-D ``DeviceMesh`` over every rank of the default process group.

    ``device_type`` defaults to the device the group's backend serves
    (``"cuda"`` for NCCL, ``"cpu"`` for gloo).  The group must exist
    already: this never starts one.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_user_mesh needs a torch.distributed process group: call "
            "torch.distributed.init_process_group (nccl for CUDA devices, "
            "gloo for the CPU) on every rank first, or start the ranks "
            "with repro_torch.core.distributed.run_ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def check_backend(backend: str, device: torch.device) -> None:
    """Raise unless ``backend`` is the collective backend of ``device``:
    a CUDA engine takes an NCCL group, a CPU engine a gloo group."""
    want = BACKEND_FOR[device.type]
    if backend != want:
        raise ValueError(
            f"a {device.type} engine needs a {want} process group, got "
            f"{backend}: build the mesh over the engine's device type")


def axis_group(mesh, axis: str, device: torch.device):
    """The process group of ``mesh``'s axis ``axis``, checked against the
    engine's ``device`` (mesh device type and collective backend)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh is over {mesh.device_type!r} devices but the engine "
            f"runs on {device}")
    group = mesh.get_group(axis)
    check_backend(dist.get_backend(group), device)
    return group


def local_rows(n: int, group, axis: str, what: str = "n_users"
               ) -> slice:
    """This rank's rows ``[r n / W, (r + 1) n / W)`` of a sharded axis of
    length ``n``; raises the reference's message unless W divides n."""
    size = dist.get_world_size(group)
    if n % size:
        raise ValueError(f"{what}={n} not divisible by mesh axis {axis!r}"
                         f" of size {size}")
    per = n // size
    rank = dist.get_rank(group)
    return slice(rank * per, (rank + 1) * per)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along
    axis 0 in rank order: the reference's ``all_gather(tiled=True)``.
    ``group=None`` (one device, nothing sharded) returns ``x``."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def distributed_similarity(features, mesh, cfg=None, axis: str = "data",
                           n_valid=None) -> torch.Tensor:
    """Run the one-shot similarity protocol sharded over ``mesh[axis]``.

    Every rank passes the same full ``features (N, n, d)``, with ``N``
    divisible by the axis size; each moves only its own users to its
    device (the rank's current CUDA device, or the CPU, as the mesh's
    device type says).  Returns the replicated ``R (N, N)``.
    """
    from repro_torch.core import similarity as sim
    from repro_torch.core.engine import ProtocolEngine

    cfg = dataclasses.replace(cfg or sim.SimilarityConfig(),
                              backend="shard_map", block_users=0,
                              mesh_axis=axis)
    return ProtocolEngine(cfg, mesh=mesh, device=mesh.device_type
                          ).similarity(features, n_valid=n_valid)


# ---------------------------------------------------------------------------
# Starting the ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, device_type: str, store: str,
               threads: int, fn, args, out) -> None:
    """One rank: join the group, run ``fn(rank, world, *args)``, report
    its value (or its traceback), and leave the group."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(BACKEND_FOR[device_type],
                                init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            # Pickled here, not in the queue's feeder thread, so that a
            # value that cannot cross fails this rank instead of vanishing.
            out.put((rank, True, pickle.dumps(fn(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, device_type: str = "cuda", args: tuple = (),
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one process group and return their values in rank order.

    Rank r runs on ``cuda:r`` over NCCL, or on the CPU over gloo with
    this process's torch threads shared out.  The processes are started
    with the spawn context (a parent that has used CUDA cannot fork);
    ``fn``, ``args`` and the values cross by pickle.  The group meets
    through a file store in a fresh temporary directory.  Raises if any
    rank fails or dies, or if the ranks have not all finished within
    ``timeout`` seconds; every process is ended either way.
    """
    import torch.multiprocessing as mp

    if device_type not in BACKEND_FOR:
        raise ValueError(f"device_type must be one of {tuple(BACKEND_FOR)},"
                         f" got {device_type!r}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"{world} ranks need {world} CUDA devices; this host has "
            f"{torch.cuda.device_count()} (NCCL takes one rank a device)")
    threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, device_type,
                               os.path.join(tmp, "store"), threads, fn,
                               args, out), daemon=True)
             for r in range(world)]
    results: dict[int, object] = {}
    failures: list[str] = []
    try:
        for p in procs:
            p.start()
        # Drain the queue before joining: a child blocks on exit until
        # what it put has been read.
        deadline = time.monotonic() + timeout
        while len(results) + len(failures) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code "
                                       f"{dead[0]}") from None
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world - len(results)} of {world} ranks had not "
                        f"finished after {timeout:.0f} s") from None
                continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                failures.append(f"rank {rank}:\n{value}")
                break
        if failures:
            raise RuntimeError("a rank failed:\n" + "\n".join(failures))
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"rank exit codes {codes}")
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Collectives with autograd: the transposes shard_map gives the reference
# ---------------------------------------------------------------------------

class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) over a process group of per-rank partials into a
    value the rest of the computation treats as replicated: its backward
    is the identity (each rank's partial gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradSummed(torch.autograd.Function):
    """The identity, whose backward sums the gradient over a process
    group: a value replicated over ranks that each use it on their own
    shard of the other operands (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return funcol.wait_tensor(funcol.all_reduce(
            grad.contiguous(), "sum", ctx.group)), None


def grad_summed(x: torch.Tensor, groups) -> torch.Tensor:
    """``x``, with its gradient summed over each process group of
    ``groups`` (``_GradSummed``)."""
    for g in groups:
        x = _GradSummed.apply(x, g)
    return x


def sum_replicated(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each process group of ``groups``
    (``_SumReplicated``)."""
    for g in groups:
        x = _SumReplicated.apply(x, g)
    return x
