"""The train step: loss, gradients and AdamW on one device.

The port's copy of ``repro.train.step``'s single-device path: the plain
step and gradient accumulation over ``run.microbatch``.  The gradients come
from ``torch.autograd.grad`` through the sequence forward (flash attention
with its backward kernel, per-layer activation checkpointing under
``run.remat``).  The reference's multi-device pieces, ``train_state_
shardings``, ``batch_shardings`` and the compressed-DP variant (an int8
ring all-reduce over a mesh axis), wait for a later slice; with no mesh
the reference returns the plain step even when ``compress_grads`` is set,
and so does the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import tree
from repro_torch.config import RunConfig
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState


@dataclass
class TrainState:
    params: Any
    opt: AdamWState
    step: torch.Tensor           # int32 scalar
    ef_residual: Any = None      # error-feedback state (compression only)


def make_train_state(run: RunConfig, gen: torch.Generator, *,
                     device="cuda") -> TrainState:
    """Parameters from ``gen`` (a generator on ``device``), zero moments.
    The reference's ``compress`` / ``dp_size`` size the compressed-DP
    step's residual, which waits with that step for a later slice."""
    params = transformer.init_params(run.model, gen, device=device)
    return TrainState(params=params, opt=adamw.adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=torch.device(device)))


def build_train_step(run: RunConfig):
    """-> train_step(state, batch) -> (state, metrics).

    ``batch``: tensors on the parameters' device (``tokens`` and
    ``labels`` int32 [B, S]).  The step updates the state's parameters and
    moments in place (the reference donates them) and returns it with
    ``step + 1``; the metrics (``loss``, ``tokens``, ``grad_norm``, ``lr``)
    stay device tensors.
    """
    cfg = run.model

    def loss_and_grads(flat: list, treedef, batch: dict):
        leaves = [p.detach().requires_grad_() for p in flat]
        loss, metrics = transformer.loss_fn(
            cfg, tree.unflatten(treedef, leaves), batch, run.remat)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def grads_of(params, batch: dict):
        flat, treedef = tree.flatten(params)
        if run.microbatch <= 1:
            loss, metrics, grads = loss_and_grads(flat, treedef, batch)
            return loss, metrics, tree.unflatten(treedef, grads)
        # gradient accumulation over microbatches, float32 sums
        mb = run.microbatch
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in flat]
        losses, metrics = [], []
        for i in range(mb):
            part = {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
                    for k, x in batch.items()}
            loss, m, grads = loss_and_grads(flat, treedef, part)
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
            losses.append(loss)
            metrics.append(m)
        grads = [g / mb for g in gsum]
        mean = {k: torch.stack([m[k] for m in metrics]).float().mean()
                for k in metrics[0]}
        return (torch.stack(losses).mean(), mean,
                tree.unflatten(treedef, grads))

    def plain_step(state: TrainState, batch: dict):
        _, metrics, grads = grads_of(state.params, batch)
        new_params, new_opt, opt_metrics = adamw.adamw_update(
            run.optim, grads, state.opt, state.params)
        metrics = dict(metrics, **opt_metrics)
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1,
                          ef_residual=state.ef_residual), metrics

    return plain_step
