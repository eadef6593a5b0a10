"""Device resolution and kernel launch counts, shared by every wrapper.

Mirrors ``src/repro/kernels/dispatch.py``: where the reference decides
between lowered and interpreted Pallas, the port decides by the tensor's
device.  A CUDA tensor goes through the hand-written kernel; a CPU
tensor goes through the plain PyTorch version.  There is no silent
fallback: a missing card is an error unless the caller asked for the CPU.

``count_launch`` is the one place a launch is counted: in ``LAUNCHES``
always, and through ``record_dispatch`` in the telemetry registry while
``repro_torch.obs`` is enabled, once a launch: by ``count_launch``
itself, or, for a plan resolved by ``tuning.get_blocks``, by that.

The kernels have no backward (nor do the reference's Pallas calls): a
kernel writes into a fresh tensor, whose lack of a ``grad_fn`` would
cut a gradient without a word.  ``refuse_grad`` makes a wrapper raise
instead, on a CUDA input that requires grad while grad mode is on.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs

__all__ = ["LAUNCHES", "FAMILIES", "resolve_device", "backend_kind",
           "device_kind", "on_cuda", "count_launch", "reset_launches",
           "stream_of", "aligned16", "record_dispatch", "refuse_grad",
           "on_local_shards"]

#: Kernel name -> launches since the last ``reset_launches()``.  Each
#: wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES: dict[str, int] = {"gram": 0, "eigproject": 0, "linkage": 0,
                            "linkage_step": 0, "featurize_gram": 0,
                            "gram_project": 0, "assign_wave": 0,
                            "assign_one": 0, "flash_attention": 0,
                            "wkv_chunked": 0, "linear_scan": 0}

#: Launch name -> the reference's tuning family
#: (``src/repro/kernels/tuning.py::KERNELS``), the ``kernel`` label of
#: ``kernel_calls``.  ``flash_attention`` has no family there and is not
#: recorded.
FAMILIES: dict[str, str] = {"gram": "gram", "eigproject": "eigproject",
                            "linkage": "linkage", "linkage_step": "linkage",
                            "featurize_gram": "featurize_gram",
                            "gram_project": "gram_project",
                            "assign_wave": "assign", "assign_one": "assign",
                            "wkv_chunked": "recurrent_scan",
                            "linear_scan": "recurrent_scan"}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; ``"cuda"`` is the default.

    Raises when a CUDA device is asked for and none is present: the port
    runs on the CPU only when the caller says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def backend_kind(device: str | torch.device = "cuda") -> str:
    """Platform of the device, in the reference's words: ``"gpu"`` for
    a CUDA device, ``"cpu"`` for the host."""
    return "gpu" if resolve_device(device).type == "cuda" else "cpu"


def device_kind(device: str | torch.device = "cuda") -> str:
    """Hardware model of the device (e.g. ``"NVIDIA H100 80GB HBM3"``)."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if a launch of ``kernel`` on ``tensors`` would cut a
    gradient: grad mode is on and an input requires grad.  Under
    ``torch.no_grad()`` or ``torch.inference_mode()``, or on inputs that
    need no gradient, it does nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and an input "
            f"requires grad; launch it under torch.no_grad(), or train on "
            f"the plain path (attn_impl='jnp', rec_impl 'chunked' or "
            f"'scan'), as the reference does")


def _align(kernel: str, args: tuple, in_dims: tuple[str, ...], local: str,
           move: bool) -> tuple:
    """The arguments placed alike: each mesh axis shards one labelled dim
    in every argument that has it (a replicated argument takes its local
    slice, which moves nothing; a partial sum is summed first).  One axis
    over different dims raises; so does an axis over a dim outside ``local``,
    unless ``move``: then every argument's sharding on that axis is moved
    onto one ``local`` dim that it divides and no other axis shards (one
    an argument is sharded on already, else the first in ``local``'s
    order), all-to-alls (a scan's sequence traded for its heads), never a
    gather."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = args[0].device_mesh
    # a partial sum is summed first (an all-reduce): its shards hold no
    # values of their own
    args = tuple(a.redistribute(mesh, [
        Replicate() if p.is_partial() else p for p in a.placements])
        if any(p.is_partial() for p in a.placements) else a for a in args)
    targets: list[str | None] = []
    for axis in range(mesh.ndim):
        labels = {dims[a.placements[axis].dim]
                  for a, dims in zip(args, in_dims)
                  if isinstance(a.placements[axis], Shard)}
        if not move:
            if len(labels) > 1:
                raise ValueError(f"{kernel}: mesh axis {axis} shards "
                                 f"different dims of its inputs")
            if labels and not labels <= set(local):
                raise ValueError(
                    f"{kernel}: mesh axis {axis} shards dim "
                    f"{labels.pop()!r}; the kernel takes only {local!r} "
                    f"dims sharded")
            targets.append(labels.pop() if labels else None)
            continue
        label = None
        kept = [lb for lb in local if lb in labels]
        if kept:
            # a dim some argument is already sharded on stays (a dim over
            # several axes is split in mesh order)
            label = kept[0]
        elif labels:
            size = mesh.size(axis)
            fits = [lb for lb in local if lb not in targets and all(
                a.shape[dims.index(lb)] % size == 0
                for a, dims in zip(args, in_dims) if lb in dims)]
            label = fits[0] if fits else None
            if label is None:
                raise ValueError(f"{kernel}: mesh axis {axis} shards a dim "
                                 f"outside {local!r}, and no {local!r} dim "
                                 f"divides over it")
        targets.append(label)
    out = []
    for a, dims in zip(args, in_dims):
        want = [Shard(dims.index(t)) if t is not None and t in dims
                else Replicate() for t in targets]
        out.append(a if list(a.placements) == want
                   else a.redistribute(mesh, want))
    return tuple(out), targets


def on_local_shards(kernel: str, fn, args: tuple, in_dims: tuple[str, ...],
                    out_dims: str | tuple[str, ...], local: str,
                    move: bool = False):
    """``fn(*args)``; on DTensors, ``fn`` on each rank's local shards
    through ``local_map``.  ``in_dims`` labels each argument's dims (one
    letter a dim, e.g. ``"bshd"``), ``out_dims`` each output's; the
    dims in ``local`` (batch, heads, channels) are the ones a shard of
    which the kernel computes alone.  A plain tensor among DTensors is
    replicated (the same value on every rank).  A placement that shards
    another dim, or one mesh axis over different dims, raises
    (``_align``): nothing is gathered or replicated to make a launch
    fit.  With ``move`` (the plain scans), an axis sharding
    another dim is first moved onto a ``local`` one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args)
    args, targets = _align(kernel, args, in_dims, local, move)
    # an argument replicated over an axis that shards the others (u of
    # every batch shard) has its gradient summed over that axis
    summed = [[mesh.get_group(i) for i, t in enumerate(targets)
               if t is not None and t not in dims]
              for dims in in_dims]
    if any(summed) and torch.is_grad_enabled():
        from repro_torch.core.distributed import grad_summed

        inner = fn

        def fn(*shards):
            return inner(*(grad_summed(a, g) if g and a.requires_grad
                           else a for a, g in zip(shards, summed)))

    def placements(dims: str):
        return tuple(Shard(dims.index(lb)) if lb is not None and lb in dims
                     else Replicate() for lb in targets)

    from torch.distributed.tensor.experimental import local_map

    outs = ((placements(out_dims),) if isinstance(out_dims, str)
            else tuple(placements(d) for d in out_dims))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(a.placements for a in args),
                     device_mesh=mesh)(*args)


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as the kernels'
    16-byte and TMA loads need: a view whose storage offset breaks the
    alignment is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def record_dispatch(kernel: str, blocks: dict | None = None) -> None:
    """Telemetry tap for kernel dispatches (the reference's
    ``dispatch.record_dispatch``).

    Feeds ``dispatch_count`` (stack-wide total), per-family
    ``kernel_calls{kernel=..}`` counters, and a ``kernel_blocks`` gauge
    holding the launch plan, where the wrapper computed one.
    """
    if not obs.enabled():
        return
    obs.count("dispatch_count")
    obs.count("kernel_calls", kernel=kernel)
    if blocks:
        plan = ",".join(f"{k}={blocks[k]}" for k in sorted(blocks))
        obs.gauge("kernel_blocks", plan, kernel=kernel)


def count_launch(name: str, plan=None, *, recorded: bool = False) -> None:
    """Count one launch of kernel ``name``; ``plan`` is the launch plan
    (a dataclass) where the wrapper computed one.  ``recorded``: the
    launch's plan came from ``tuning.get_blocks``, which recorded the
    dispatch already, so it is not recorded twice."""
    LAUNCHES[name] += 1
    if obs.enabled() and name in FAMILIES and not recorded:
        record_dispatch(FAMILIES[name], None if plan is None
                        else dataclasses.asdict(plan))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
