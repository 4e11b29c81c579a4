"""AdamW with warmup + cosine schedule, global-norm clipping, float32 state.

The port's copy of ``repro.optim.adamw``.  The state is a plain tree (m, v
mirror the parameters; count a scalar), so it packs straight into the
bridge's :mod:`repro_torch.core.zero_bridge` pools and into the
checkpointer.  Every scalar (count, lr, the clip scale) stays a device
tensor, so a step never waits for the host.  Where the reference donates
the state to the jitted step, :func:`adamw_update` updates the parameters,
m and v in place and returns them; the arithmetic is the reference's, in
its order, in float32, each parameter cast back to its dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import tree
from repro_torch.config import OptimConfig


@dataclass
class AdamWState:
    m: Any
    v: Any
    count: torch.Tensor      # int32 scalar


def adamw_init(params: Any) -> AdamWState:
    leaf = tree.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(m=tree.tree_map(zeros, params),
                      v=tree.tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=leaf.device))


def lr_schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """float32 learning rate at ``step`` (an int32 tensor): linear warmup,
    then a cosine from ``lr`` down to ``0.1 lr`` at ``total_steps``."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps).float()
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads: Any) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.leaves(grads))
    return torch.sqrt(sq)


def adamw_update(cfg: OptimConfig, grads: Any, state: AdamWState,
                 params: Any) -> tuple[Any, AdamWState, dict]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}); the
    parameters, m and v are updated in place (the reference donates them)
    and returned in their trees."""
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = lr_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        step_ = lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * p.float())
        p.copy_((p.float() - step_).to(p.dtype))

    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state.m), tree.leaves(state.v)):
        upd(p, g, m, v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(m=state.m, v=state.v, count=count), metrics
