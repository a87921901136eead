"""JAX parameter pytree -> the port's parameters.

The JAX package's ``init`` returns a nested dict: stacked ``layers`` (a
leading L axis on every leaf), ``embed`` and ``final_norm``
(src/repro/models/transformer.py ``init_model``), and for a MoE config
with a dense prelude a ``prelude`` list of unstacked layer dicts. The port
keeps that layout but stacks the prelude over a leading axis like
``layers``, so conversion is a checked leaf-by-leaf copy: the tree must
have exactly the port's keys and shapes (``transformer.param_shapes``), and
each leaf is cast to the config's parameter dtype on ``device``, except
the MoE router, which stays f32 as the JAX package keeps it. Leaves arrive
as numpy arrays (``jax.device_get`` of the tree); bfloat16 leaves pass
through float32, which is exact. ``to_numpy`` gives back the JAX layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.moe import leaf_dtype
from repro_torch.models.transformer import layer, param_shapes


def _stack_list(layers: list):
    """A list of per-layer dicts -> one dict of leaves stacked on axis 0."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_list([lp[k] for lp in layers]) for k in first}
    return np.stack([np.asarray(a, dtype=np.float32) for a in layers])


def from_jax(tree: dict, cfg: ModelConfig, *, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    if isinstance(tree.get("prelude"), list):
        tree = {**tree, "prelude": _stack_list(tree["prelude"])}

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
        return torch.from_numpy(a).to(
            device=device, dtype=leaf_dtype(path.rsplit("/", 1)[-1], dt))

    return walk(tree, param_shapes(cfg), "")


def to_numpy(params: dict) -> dict:
    """The port's parameters as a tree of float32 numpy arrays, in the JAX
    layout (the prelude a list of per-layer dicts)."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else v.detach().float().cpu().numpy()
                for k, v in node.items()}
    out = walk(params)
    if "prelude" in out:
        pre = out["prelude"]
        out["prelude"] = [layer(pre, i)
                          for i in range(len(pre["ln1"]["scale"]))]
    return out
