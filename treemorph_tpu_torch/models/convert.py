"""Weight bridge: flax ``variables`` of the JAX package's ``TreeLearn.init``
to the port's :class:`~treemorph_tpu_torch.models.treelearn.TreeLearn`
``state_dict``.

The port's modules carry the flax names, so a flax path maps to a torch key
by joining it with dots. Leaves map as follows (the inverse of
``treemorph_tpu/train/import_torch.py``):

- submanifold kernels ``(K, Cin, Cout)``, octant ``down_kernel`` /
  ``up_kernel`` ``(8, Cin, Cout)`` and ``shortcut`` ``(Cin, Cout)``: as
  they are;
- ``Dense_i`` ``kernel (in, out)`` -> ``Linear.weight (out, in)``, ``bias``
  as it is;
- ``MaskedBatchNorm`` ``scale`` / ``bias`` -> ``weight`` / ``bias``, and
  ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  (flax momentum 0.9 is torch momentum 0.1).

Inputs are nested dicts of numpy arrays (``jax.device_get`` of the
variables); nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _walk(tree: dict, prefix: tuple = ()):
    for name, value in tree.items():
        path = prefix + (name,)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _walk(dict(value), path)
        else:
            yield path, np.asarray(value)


def flax_to_state_dict(variables) -> dict[str, torch.Tensor]:
    """``state_dict`` of the port's TreeLearn for flax ``variables``
    (a mapping with ``params`` and ``batch_stats``)."""
    out: dict[str, torch.Tensor] = {}
    params = dict(variables["params"])
    bn_modules = {
        path[:-1] for path, _ in _walk(params) if path[-1] == "scale"
    }
    for path, value in _walk(params):
        module, leaf = path[:-1], path[-1]
        if module in bn_modules:
            name = {"scale": "weight", "bias": "bias"}[leaf]
        elif module and module[-1].startswith("Dense_"):
            name = leaf if leaf == "bias" else "weight"
            if leaf == "kernel":
                value = value.T
        else:
            name = leaf
        key = ".".join(module + (name,))
        out[key] = torch.from_numpy(np.array(value, np.float32))
    for path, value in _walk(dict(variables.get("batch_stats", {}))):
        module, leaf = path[:-1], path[-1]
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        key = ".".join(module + (name,))
        out[key] = torch.from_numpy(np.array(value, np.float32))
    return out
