"""Training launcher of the port: real steps of any LM ``--arch``, with
checkpointing.  Mirrors ``src/repro/launch/train.py``.

  # on the CUDA device (the default)
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
      --steps 20 --batch 4 --seq 128

  # on the CPU, a REDUCED config
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3_1_7b --steps 5

A step is the reference's: the loss and its gradients on the plain path
(``attn_impl="jnp"``, ``rec_impl`` chunked or scan; the kernels have no
backward), the gradients clipped to global norm 1.0, AdamW under a
warm-up cosine schedule (``warmup = max(1, steps // 10)``).  Batches
are ``data/tokens.py::token_batch_iterator``'s, seeded through numpy, so
they equal the reference's; a fusion config adds zero patch embeddings
on the first ``patch_frac`` of the positions, and an encoder-decoder
config frames of ``0.1 x`` a standard normal from a ``torch.Generator``
seeded by the step (the reference draws them from ``jax.random``, which
torch cannot reproduce).  Weights are the port's random init (seed 0).

Checkpoints (``checkpoint/ckpt.py``) hold ``(params, opt_state)`` in the
reference's tree layout (``convert.reference_tree``), AdamW's ``m`` and
``v`` too, every ``--ckpt-every`` steps and at the end; a run finds the
newest in ``--ckpt-dir`` and continues from it.  On resume
the batch stream skips the batches the saved steps consumed, so that a
resumed run takes the batches, and gives the losses, of an
uninterrupted one (the reference restarts its stream).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs, optim
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.convert import reference_named, reference_tree
from repro_torch.data import tokens as tok
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.registry import ModelBundle, get_model

__all__ = ["make_optimizer", "make_batch", "batch_stream", "train_step",
           "checkpoint_tree", "checkpoint_template", "load_checkpoint_tree",
           "build_parser", "main"]

#: Gradients are clipped to this global norm before the update.
CLIP_NORM = 1.0


def make_optimizer(lr: float, steps: int) -> optim.Optimizer:
    """The reference launcher's AdamW with a warm-up cosine schedule."""
    return optim.adamw(optim.warmup_cosine_schedule(
        lr, warmup=max(1, steps // 10), total_steps=steps))


def batch_stream(cfg: ArchConfig, batch: int, seq: int):
    """The reference launcher's token batches (numpy-seeded)."""
    spec = tok.TokenTaskSpec(vocab=min(cfg.vocab, 256), seed=0)
    return tok.token_batch_iterator(spec, batch, seq, seed=1)


def make_batch(cfg: ArchConfig, raw: dict, step: int,
               device: torch.device) -> dict:
    """One iterator batch on ``device`` as the model takes it: tokens and
    labels modulo the vocabulary; a fusion config's zero patches and
    their mask; an encoder-decoder config's frames, drawn from a
    generator seeded by ``step``."""
    b, s = raw["tokens"].shape
    batch = {key: torch.from_numpy(raw[key] % cfg.vocab).to(device)
             for key in ("tokens", "labels")}
    if cfg.fuse_patches:
        p = max(1, int(s * cfg.patch_frac))
        batch["patch_embeds"] = torch.zeros((b, p, cfg.d_model),
                                            dtype=torch.float32,
                                            device=device)
        mask = np.zeros((b, s), bool)
        mask[:, :p] = True
        batch["patch_mask"] = torch.from_numpy(mask).to(device)
    if cfg.encoder_layers:
        gen = torch.Generator().manual_seed(step)
        batch["frames"] = (0.1 * torch.randn((b, s, cfg.d_model),
                                             generator=gen)).to(device)
    return batch


def train_step(m: ModelBundle, model: torch.nn.Module,
               optimizer: optim.Optimizer, opt_state: optim.OptState,
               batch: dict, shard=None, grad_placements: dict | None = None,
               clip_norm: float | None = CLIP_NORM
               ) -> tuple[optim.OptState, torch.Tensor]:
    """One step, in place on ``model``'s parameters (which must require
    grad): returns the new optimizer state and the loss, a 0-dim tensor
    on the device (not synchronised).

    Under a mesh (``launch/steps.py::make_train_step``) the parameters
    are DTensors, ``shard`` constrains the activations, and each gradient
    is redistributed to ``grad_placements[name]`` (its parameter's
    placements by default) before the clip and the update.  The loss
    then comes back as a plain tensor, its global value."""
    from torch.distributed.tensor import DTensor

    params = dict(model.named_parameters())
    loss = m.loss_fn(model, batch, shard)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    for k, g in grads.items():
        if isinstance(g, DTensor):
            want = (grad_placements or {}).get(k, params[k].placements)
            if tuple(g.placements) != tuple(want):
                grads[k] = g.redistribute(g.device_mesh, want)
    if clip_norm is not None:
        grads = optim.clip_by_global_norm(grads, clip_norm)
    with torch.no_grad():
        values = {k: p.detach() for k, p in params.items()}
        updates, opt_state = optimizer.update(grads, opt_state, values)
        del grads
        for k, new in optim.apply_updates(values, updates).items():
            params[k].copy_(new)
    loss = loss.detach()
    return opt_state, (loss.full_tensor() if isinstance(loss, DTensor)
                       else loss)


def checkpoint_tree(cfg: ArchConfig, model, opt_state: optim.OptState
                    ) -> tuple:
    """``(params, opt_state)`` in the reference's tree layout: ``model``
    (or a dict keyed by its parameter names) and AdamW's ``m`` and ``v``
    through ``convert.reference_tree``, the leaves tensors where they
    live (layers stacked where the reference stacks them), which
    ``save_checkpoint`` takes to the host."""
    inner = {key: reference_tree(cfg, opt_state.inner[key])
             for key in ("m", "v")}
    return (reference_tree(cfg, model),
            optim.OptState(step=opt_state.step, inner=inner))


def _meta(named) -> dict:
    return {name: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for name, t in named}


def checkpoint_template(cfg: ArchConfig, model: torch.nn.Module,
                        opt_state: optim.OptState) -> tuple:
    """``checkpoint_tree``'s structure, shapes and dtypes as meta tensors:
    the template ``restore_checkpoint`` fills, with nothing copied."""
    step = torch.empty((), dtype=opt_state.step.dtype, device="meta")
    inner = {key: _meta(opt_state.inner[key].items()) for key in ("m", "v")}
    return checkpoint_tree(cfg, _meta(model.named_parameters()),
                           optim.OptState(step=step, inner=inner))


def load_checkpoint_tree(cfg: ArchConfig, model: torch.nn.Module,
                         tree: tuple) -> optim.OptState:
    """Copy a restored ``checkpoint_template`` into ``model``'s
    parameters; returns the optimizer state it holds (``m`` and ``v``
    where they were restored, the step on the host as AdamW keeps it)."""
    params, state = tree
    live = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in reference_named(cfg, params).items():
            live[name].copy_(value)
    inner = {key: reference_named(cfg, state.inner[key])
             for key in ("m", "v")}
    return optim.OptState(step=state.step.cpu(), inner=inner)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv=None) -> list[float]:
    """Run the launcher; returns the losses of the steps it ran."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=bool(args.reduced))
    m = get_model(cfg)
    model = m.init(0, device=device)
    model.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, 1 device(s) "
          f"({device.type})")
    optimizer = make_optimizer(args.lr, args.steps)
    opt_state = optimizer.init(dict(model.named_parameters()))
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, start = restore_checkpoint(
            args.ckpt_dir, checkpoint_template(cfg, model, opt_state),
            device=device)
        opt_state = load_checkpoint_tree(cfg, model, tree)
        print(f"restored step {start} from {args.ckpt_dir}")

    it = batch_stream(cfg, args.batch, args.seq)
    for _ in range(start):          # the batches the saved steps took
        next(it)
    losses = []     # device scalars, read on print steps and at the end
    t0 = obs.now()    # monotonic perf_counter: never time.time for rates
    for i in range(start, args.steps):
        batch = make_batch(cfg, next(it), i, device)
        opt_state, loss = train_step(m, model, optimizer, opt_state, batch)
        losses.append(loss)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            tps = args.batch * args.seq / max(obs.now() - t0, 1e-9)
            print(f"step {i:5d}  loss {float(loss):.4f}  ({tps:.0f} tok/s)")
            t0 = obs.now()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            checkpoint_tree(cfg, model, opt_state))
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps,
                        checkpoint_tree(cfg, model, opt_state))
        print(f"final checkpoint at {args.ckpt_dir}")
    return [float(loss) for loss in losses]

if __name__ == "__main__":
    main()
