"""Carry the reference's parameters (and training state) across to the port.

The reference stacks the layers of each pattern period on a leading dim
(``params["periods"]["pos<i>"]``) and keeps a pattern remainder under
``params["tail"]``; the port keeps one dict per layer in a list.  Weights
keep their ``[in, out]`` layout and the embedding stays
``[padded_vocab, d]`` (tied as the unembedding when the config ties them).
:func:`train_state_from_reference` carries a whole training state
(parameters, AdamW m, v and count, step), so both packages can start a
step from the same state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16, bit-cast
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(tree: Any, index, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, index, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return _tensor(a if index is None else a[index], device)


def from_reference(params_np: dict, cfg: ModelConfig, *,
                   device="cuda") -> dict[str, Any]:
    """Reference parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's parameters."""
    period = len(tuple(cfg.layer_pattern))
    n_periods = cfg.num_layers // period
    layers = []
    for li in range(cfg.num_layers):
        if li < n_periods * period:
            src = params_np["periods"][f"pos{li % period}"]
            layers.append(_tree(src, li // period, device))
        else:
            src = params_np["tail"][f"layer{li - n_periods * period}"]
            layers.append(_tree(src, None, device))
    out = {"embed": _tensor(params_np["embed"], device),
           "out_norm": _tensor(params_np["out_norm"], device),
           "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(params_np["lm_head"], device)
    return out


def train_state_from_reference(state_np: Any, cfg: ModelConfig, *,
                               device="cuda"):
    """A reference ``TrainState`` whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's
    :class:`~repro_torch.train.step.TrainState`: parameters, m and v laid
    out as :func:`from_reference` lays out parameters, ``count`` and
    ``step`` int32 scalars.  The reference's error-feedback residual (the
    compressed-DP step's) is not carried."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState
    opt = state_np.opt
    return TrainState(
        params=from_reference(state_np.params, cfg, device=device),
        opt=AdamWState(m=from_reference(opt.m, cfg, device=device),
                       v=from_reference(opt.v, cfg, device=device),
                       count=_tensor(np.asarray(opt.count, np.int32),
                                     device)),
        step=_tensor(np.asarray(state_np.step, np.int32), device))
