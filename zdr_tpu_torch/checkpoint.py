"""Checkpoint / resume for texture optimization runs (port of
zdr_tpu/checkpoint.py).

Saves the material texture, the optimizer's state and the step counter
atomically (a temporary file, then os.replace), so long recovery runs
survive preemption. The file is the JAX package's npz: "material", "step",
"n_opt_leaves", "opt_<i>" (optax.adam's state leaves in its tree order:
count, mu, nu; convert.ADAM_LEAVES) and "x_<name>" extras, so a checkpoint
moves both ways between the packages. The optimizer is a torch.optim.Adam
over the one material tensor.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .convert import adam_state_from_numpy, adam_state_to_numpy


def _the_param(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"a torch.optim.Adam is expected, got {type(optimizer).__name__}")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != 1:
        raise ValueError(f"the optimizer must hold the one material tensor, it holds "
                         f"{len(params)}")
    if optimizer.param_groups[0].get("amsgrad"):
        raise ValueError("amsgrad has no optax.adam state")
    return params[0]


def save_checkpoint(path: str, material: torch.Tensor, optimizer: torch.optim.Adam, step: int,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write material + optimizer state + step to `path` (.npz)."""
    leaves = adam_state_to_numpy(optimizer.state.get(_the_param(optimizer), {}), material)
    payload = {
        "material": material.detach().to("cpu", torch.float32).numpy(),
        "step": np.asarray(step, np.int64),
        "n_opt_leaves": np.asarray(len(leaves), np.int64),
    }
    for i, leaf in enumerate(leaves):
        payload[f"opt_{i}"] = leaf
    for k, v in (extra or {}).items():
        payload[f"x_{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, optimizer: torch.optim.Adam) -> Tuple[torch.Tensor, int,
                                                                     Dict[str, np.ndarray]]:
    """Restore a checkpoint into `optimizer`, a torch.optim.Adam over one
    material tensor (a fresh run's, as the JAX package's template): the
    tensor takes the saved material in place, the optimizer the saved
    moments and step -> (the material, step, extras)."""
    param = _the_param(optimizer)
    with np.load(path) as raw:
        material = raw["material"]
        n = int(raw["n_opt_leaves"])
        leaves = [raw[f"opt_{i}"] for i in range(n)]
        step = int(raw["step"])
        extras = {k[2:]: raw[k] for k in raw.files if k.startswith("x_")}
    if tuple(material.shape) != tuple(param.shape):
        raise ValueError(f"checkpoint material {material.shape}, optimizer's {tuple(param.shape)}")
    group = optimizer.param_groups[0]
    on_param = group.get("capturable") or group.get("fused")
    state = adam_state_from_numpy(leaves, param.device,
                                  step_device=param.device if on_param else "cpu")
    with torch.no_grad():
        param.copy_(torch.as_tensor(material, device=param.device))
    optimizer.state[param] = state
    return param, step, extras
