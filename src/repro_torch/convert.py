"""JAX parameter pytree -> the port's parameters.

The JAX package's ``init`` returns a nested dict: stacked ``layers`` (a
leading L axis on every leaf), ``embed`` and ``final_norm``
(src/repro/models/transformer.py ``init_model``). The port keeps that
layout, so conversion is a checked leaf-by-leaf copy: the tree must have
exactly the port's keys and shapes (``transformer.param_shapes``), and
each leaf is cast to the config's parameter dtype on ``device``. Leaves
arrive as numpy arrays (``jax.device_get`` of the tree); bfloat16 leaves
pass through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import param_shapes


def from_jax(tree: dict, cfg: ModelConfig, *, device) -> dict:
    dt = dtype_of(cfg.param_dtype)

    def walk(node, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(node, dict) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(shapes)}, got {got}")
            return {k: walk(node[k], shapes[k], f"{path}/{k}")
                    for k in shapes}
        a = np.array(node, dtype=np.float32)     # a writable copy
        if a.shape != tuple(shapes):
            raise ValueError(f"{path}: expected shape {tuple(shapes)}, got "
                             f"{a.shape}")
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return walk(tree, param_shapes(cfg), "")


def to_numpy(params: dict) -> dict:
    """The port's parameters as a tree of float32 numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
