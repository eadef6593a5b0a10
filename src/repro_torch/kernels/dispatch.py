"""Device resolution and kernel launch counts, shared by every wrapper.

Mirrors ``src/repro/kernels/dispatch.py``: where the reference decides
between lowered and interpreted Pallas, the port decides by the tensor's
device.  A CUDA tensor goes through the hand-written kernel; a CPU
tensor goes through the plain PyTorch version.  There is no silent
fallback: a missing card is an error unless the caller asked for the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "resolve_device", "device_kind", "on_cuda",
           "count_launch", "reset_launches", "stream_of", "aligned16"]

#: Kernel name -> launches since the last ``reset_launches()``.  Each
#: wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES: dict[str, int] = {"gram": 0, "eigproject": 0, "linkage": 0,
                            "linkage_step": 0, "featurize_gram": 0,
                            "gram_project": 0, "assign_wave": 0,
                            "assign_one": 0, "flash_attention": 0,
                            "wkv_chunked": 0, "linear_scan": 0}


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


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as the kernels'
    16-byte and TMA loads need: a view whose storage offset breaks the
    alignment is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
