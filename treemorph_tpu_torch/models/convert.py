"""Weight bridge: flax ``variables`` of the JAX package's models to the
``state_dict`` of the port's
:class:`~treemorph_tpu_torch.models.treelearn.TreeLearn`,
:class:`~treemorph_tpu_torch.models.ptv3.PointTransformerWithHeads` and
:class:`~treemorph_tpu_torch.models.pointnet2.PointNet2`.

The port's modules carry the flax names, so a flax path maps to a torch key
by joining it with dots. Leaves map as follows (the inverse of
``treemorph_tpu/train/import_torch.py``):

- conv kernels ``(K, Cin, Cout)`` (TreeLearn's submanifold convs, PTv3's
  stem and xCPEs), octant ``down_kernel`` / ``up_kernel``
  ``(8, Cin, Cout)``, ``shortcut`` ``(Cin, Cout)`` and the xCPE's conv
  ``bias``: as they are;
- every ``Dense`` ``kernel (in, out)``, whether auto-named (``Dense_i``) or
  named (PTv3's ``qkv``, ``proj``, ``proj_skip``) -> ``Linear.weight
  (out, in)``, ``bias`` as it is; a ``kernel`` leaf is a ``Dense`` kernel
  exactly when it has two dims;
- ``MaskedBatchNorm``, ``BatchNorm`` (PointNet2's MLPs and heads) and
  ``LayerNorm`` ``scale`` / ``bias`` -> ``weight`` / ``bias``, and
  ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  (flax momentum m is torch momentum 1 - m, except in PointNet2's
  ``BatchNorm``, which keeps flax's m).

PTv3's reference-partitioning options need no rule of their own either:
the RPE ``rpe_table`` ``(3 * rpe_num, H)`` is a leaf kept as it is; a
PDNorm's ``norm{i}`` (or ``norm``) children are LayerNorms or BatchNorms,
and its ``modulation`` a ``Dense``. Nor does TreeLearn's brick engine,
whose blocks' ``conv0`` / ``conv1`` kernels are ``(27, Cin, Cout)`` leaves
and ``bn0`` / ``bn1`` BatchNorms.

PointNet2's modules keep flax's automatic names (``SetAbstraction_i``,
``SetAbstractionMsg_0``, ``PointwiseMLP_i``, ``Dense_i``, ``BatchNorm_i``,
``FeaturePropagation_j``) and the heads' ``semantic_head`` /
``offset_head``, so its leaves need no rule of their own.

Every conv engine takes its kernels as (K, Cin, Cout) in kernel-offset
order: the gather, z-pack, band and z-band engines (``ops/sparse.py``,
``ops/bandconv.py``), the pencil engine (``ops/pencil.py``), the brick
engine and brick conv (``ops/bricks.py``, ``ops/brick_conv.py``) and the
tiles (``ops/tiles.py``). So no engine adds a layout here.

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
    """``state_dict`` of the port's model for flax ``variables`` (a
    mapping with ``params`` and ``batch_stats``)."""
    out: dict[str, torch.Tensor] = {}
    params = dict(variables["params"])
    bn_modules = {
        path[:-1] for path, _ in _walk(params) if path[-1] == "scale"
    }
    for path, value in _walk(params):
        module, leaf = path[:-1], path[-1]
        if module in bn_modules:
            name = {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf == "kernel" and value.ndim == 2:
            name, value = "weight", value.T
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
