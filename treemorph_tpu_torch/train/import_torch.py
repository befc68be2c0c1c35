"""Import the reference system's PyTorch checkpoints into the port's models.

Port of ``treemorph_tpu/train/import_torch.py``. The reference trains torch
models (``Modules/TreeLearn/TreeLearn.py``, ``Modules/PointNet2/
PointNet2.py``, ``Modules/PointTransformerV3/``) and stores plain
``state_dict``s in ``.pt`` files. The converters keep the JAX package's
numpy logic, which maps those names and layouts into the flax variable
tree, and take that tree into the port's module through
:func:`treemorph_tpu_torch.models.convert.flax_to_state_dict` (the port's
modules carry the flax names). The result is checked against the port
model's own ``state_dict`` (every key, every shape) and a mismatch raises.

Layout conventions translated:

- torch ``nn.Linear``/1x1 ``ConvNd`` weight ``(out, in, *1s)`` -> flax
  Dense ``kernel`` ``(in, out)`` (the port's ``Linear.weight`` again);
- torch BatchNorm ``weight``/``bias`` -> ``scale``/``bias`` params and
  ``running_mean``/``running_var`` -> ``batch_stats`` ``mean``/``var``;
- spconv ``SubMConv3d`` weight ``(out, k, k, k, in)`` (KRSC) -> the
  ``(k^3, in, out)`` kernel-offset layout of every conv engine, with the
  same row-major (dx, dy, dz) enumeration; pass ``flip_kernel=True`` to
  reverse the offset order if a given checkpoint's spconv build used the
  mirrored convention, and :func:`permute_spconv_axes` first if it
  enumerated a different spatial axis ORDER (e.g. (kz, ky, kx)). Neither
  is detectable from shapes alone, and both mappings are validated against
  synthetic state_dicts only (spconv is not installed here);
- spconv ``SparseConv3d`` k=2 s=2 / ``SparseInverseConv3d`` weight
  ``(out, 2, 2, 2, in)`` -> the octant-indexed ``(8, in, out)`` where
  octant = (dx << 2) | (dy << 1) | dz of the fine voxel within its parent,
  matching ``ops.sparse.build_downsample``.

PTv3 checkpoints convert via :func:`convert_ptv3` (qkv/proj linears, xCPE
spconv kernels, pooling/unpooling projections+norms, the k=5 stem, MLP
heads), matching the JAX package's converter. Activation-level parity
against the reference model needs the reference's per-element window
padding, which the port's PTv3 has (``pad_per_element=True``); it is not
checked here, since neither the reference module nor one of its
checkpoints is at hand.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.convert import flax_to_state_dict


def load_state_dict(path: str) -> dict:
    """Load a .pt checkpoint to numpy (accepts raw state_dicts and
    {'model'|'state_dict'|'net': ...} wrappers)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "net"):
        if isinstance(obj, dict) and key in obj and isinstance(
            obj[key], dict
        ):
            obj = obj[key]
    return {
        k: v.detach().cpu().numpy()
        for k, v in obj.items()
        if hasattr(v, "detach")
    }


def _dense(w, b=None):
    out = {"kernel": np.ascontiguousarray(np.asarray(w).reshape(
        w.shape[0], -1).T.astype(np.float32))}
    if b is not None:
        out["bias"] = np.asarray(b, np.float32)
    return out


def _bn_params(sd, prefix):
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
    }


def _bn_stats(sd, prefix):
    return {
        "mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
        "var": np.asarray(sd[f"{prefix}.running_var"], np.float32),
    }


def _subm_kernel(w, flip_kernel=False):
    """spconv (out, k, k, k, in) -> (k^3, in, out)."""
    w = np.asarray(w, np.float32)
    out_c, k0, k1, k2, in_c = w.shape
    kernel = w.reshape(out_c, k0 * k1 * k2, in_c).transpose(1, 2, 0)
    if flip_kernel:
        kernel = kernel[::-1]
    return np.ascontiguousarray(kernel)


def permute_spconv_axes(sd: dict, kernel_axes: str = "xyz") -> dict:
    """Pre-permute every spconv weight ``(out, k, k, k, in)`` in a torch
    state_dict whose spatial enumeration order is not ``(kx, ky, kz)``.

    spconv's KRSC layout leaves the spatial ORDER convention to the
    build: a checkpoint stored as ``(kz, ky, kx)`` is shape-identical and
    undetectable, and would silently convert to a spatially-permuted
    conv. Pass ``kernel_axes='zyx'`` (or any permutation of ``'xyz'``)
    for such builds, then convert as usual; composes with
    ``flip_kernel`` (a full offset reversal) which handles the mirrored
    enumeration instead. Validated against synthetic state_dicts only —
    spconv itself is not installed here.
    """
    if kernel_axes == "xyz":
        return sd
    assert sorted(kernel_axes) == ["x", "y", "z"], kernel_axes
    perm = tuple(1 + kernel_axes.index(c) for c in "xyz")
    out = {}
    for k, v in sd.items():
        a = np.asarray(v)
        if a.ndim == 5 and a.shape[1] == a.shape[2] == a.shape[3]:
            a = np.ascontiguousarray(np.transpose(a, (0, *perm, 4)))
        out[k] = a
    return out


def _child_names(module) -> list[str]:
    return [name for name, _ in module.named_children()]


def convert_pointnet2(sd: dict, model) -> dict[str, torch.Tensor]:
    """Reference PointNet2 state_dict -> the ``state_dict`` of the port's
    :class:`~treemorph_tpu_torch.models.pointnet2.PointNet2` ``model``.

    Naming (reference ``Modules/PointNet2/PointNet2.py:24-60``):
    ``sa{k}`` set-abstraction MLPs -> ``SetAbstraction_{k-1}``,
    ``fp{k}`` feature propagation -> ``FeaturePropagation_{depth-k}``,
    ``semantic_linear``/``offset_linear`` 2-layer heads -> the
    ``*_head`` modules.
    """
    params = {}
    stats = {}
    t_params = _child_names(model)

    sa_names = sorted(
        n for n in t_params if n.startswith("SetAbstraction_")
    )
    for name in sa_names:
        k = int(name.split("_")[1]) + 1
        mlp_p, mlp_s = {}, {}
        j = 0
        while f"sa{k}.mlp_convs.{j}.weight" in sd:
            mlp_p[f"Dense_{j}"] = _dense(
                sd[f"sa{k}.mlp_convs.{j}.weight"],
                sd[f"sa{k}.mlp_convs.{j}.bias"],
            )
            mlp_p[f"BatchNorm_{j}"] = _bn_params(sd, f"sa{k}.mlp_bns.{j}")
            mlp_s[f"BatchNorm_{j}"] = _bn_stats(sd, f"sa{k}.mlp_bns.{j}")
            j += 1
        params[name] = {"PointwiseMLP_0": mlp_p}
        stats[name] = {"PointwiseMLP_0": mlp_s}

    fp_names = sorted(
        n for n in t_params if n.startswith("FeaturePropagation_")
    )
    depth = len(fp_names)
    for name in fp_names:
        k = depth - int(name.split("_")[1])
        mlp_p, mlp_s = {}, {}
        j = 0
        while f"fp{k}.mlp_convs.{j}.weight" in sd:
            mlp_p[f"Dense_{j}"] = _dense(
                sd[f"fp{k}.mlp_convs.{j}.weight"],
                sd[f"fp{k}.mlp_convs.{j}.bias"],
            )
            mlp_p[f"BatchNorm_{j}"] = _bn_params(sd, f"fp{k}.mlp_bns.{j}")
            mlp_s[f"BatchNorm_{j}"] = _bn_stats(sd, f"fp{k}.mlp_bns.{j}")
            j += 1
        params[name] = {"PointwiseMLP_0": mlp_p}
        stats[name] = {"PointwiseMLP_0": mlp_s}

    for head, ref in (
        ("semantic_head", "semantic_linear"),
        ("offset_head", "offset_linear"),
    ):
        params[head] = {
            "Dense_0": _dense(
                sd[f"{ref}.net.0.weight"], sd[f"{ref}.net.0.bias"]
            ),
            "BatchNorm_0": _bn_params(sd, f"{ref}.net.1"),
            "Dense_1": _dense(
                sd[f"{ref}.net.3.weight"], sd[f"{ref}.net.3.bias"]
            ),
        }
        stats[head] = {"BatchNorm_0": _bn_stats(sd, f"{ref}.net.1")}

    return _check_against_model(
        {"params": params, "batch_stats": stats}, model
    )


def _convert_ublock(sd, prefix, flip_kernel):
    """Recursive reference UBlock -> our UBlock subtree
    (reference ``Modules/TreeLearn/blocks.py:84-151``)."""
    p, s = {}, {}
    for i in (0, 1):  # block_reps = 2 in every reference config
        for group, ours in ((f"{prefix}.blocks.block{i}", f"block{i}"),
                            (f"{prefix}.blocks_tail.block{i}",
                             f"tail{i}")):
            if f"{group}.conv_branch.2.weight" not in sd:
                continue
            bp = {
                "MaskedBatchNorm_0": _bn_params(
                    sd, f"{group}.conv_branch.0"
                ),
                "SubMConv_0": {
                    "kernel": _subm_kernel(
                        sd[f"{group}.conv_branch.2.weight"], flip_kernel
                    )
                },
                "MaskedBatchNorm_1": _bn_params(
                    sd, f"{group}.conv_branch.3"
                ),
                "SubMConv_1": {
                    "kernel": _subm_kernel(
                        sd[f"{group}.conv_branch.5.weight"], flip_kernel
                    )
                },
            }
            bs = {
                "MaskedBatchNorm_0": _bn_stats(
                    sd, f"{group}.conv_branch.0"
                ),
                "MaskedBatchNorm_1": _bn_stats(
                    sd, f"{group}.conv_branch.3"
                ),
            }
            if f"{group}.i_branch.0.weight" in sd:
                w = sd[f"{group}.i_branch.0.weight"]
                out_c = w.shape[0]
                bp["shortcut"] = np.ascontiguousarray(
                    np.asarray(w, np.float32).reshape(out_c, -1).T
                )
            p[ours] = bp
            s[ours] = bs
    if f"{prefix}.conv.2.weight" in sd:
        p["MaskedBatchNorm_0"] = _bn_params(sd, f"{prefix}.conv.0")
        s["MaskedBatchNorm_0"] = _bn_stats(sd, f"{prefix}.conv.0")
        p["down_kernel"] = _subm_kernel(
            sd[f"{prefix}.conv.2.weight"], flip_kernel=False
        )
        p["MaskedBatchNorm_1"] = _bn_params(sd, f"{prefix}.deconv.0")
        s["MaskedBatchNorm_1"] = _bn_stats(sd, f"{prefix}.deconv.0")
        p["up_kernel"] = _subm_kernel(
            sd[f"{prefix}.deconv.2.weight"], flip_kernel=False
        )
        child_p, child_s = _convert_ublock(sd, f"{prefix}.u", flip_kernel)
        p["u"] = child_p
        s["u"] = child_s
    return p, s


def convert_treelearn(
    sd: dict, model, flip_kernel: bool = False
) -> dict[str, torch.Tensor]:
    """Reference TreeLearn state_dict -> the ``state_dict`` of the port's
    :class:`~treemorph_tpu_torch.models.treelearn.TreeLearn` ``model``.

    Naming (reference ``Modules/TreeLearn/TreeLearn.py:51-61``):
    ``input_conv``/``unet``/``output_layer`` -> backbone modules,
    ``semantic_linear``/``offset_linear`` 2-layer MLP heads -> our heads.
    """
    unet_p, unet_s = _convert_ublock(sd, "unet", flip_kernel)
    params = {
        "backbone": {
            "input_conv": {
                "kernel": _subm_kernel(
                    sd["input_conv.0.weight"], flip_kernel
                )
            },
            "unet": unet_p,
            "output_norm": _bn_params(sd, "output_layer.0"),
        }
    }
    stats = {
        "backbone": {
            "unet": unet_s,
            "output_norm": _bn_stats(sd, "output_layer.0"),
        }
    }
    for head, ref in (
        ("semantic_head", "semantic_linear"),
        ("offset_head", "offset_linear"),
    ):
        params[head] = {
            "Dense_0": _dense(sd[f"{ref}.0.weight"], sd[f"{ref}.0.bias"]),
            "MaskedBatchNorm_0": _bn_params(sd, f"{ref}.1"),
            "Dense_1": _dense(sd[f"{ref}.3.weight"], sd[f"{ref}.3.bias"]),
        }
        stats[head] = {"MaskedBatchNorm_0": _bn_stats(sd, f"{ref}.1")}

    return _check_against_model(
        {"params": params, "batch_stats": stats}, model
    )


def _ln(sd, prefix):
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
    }


def convert_ptv3(sd: dict, model,
                 flip_kernel: bool = False) -> dict[str, torch.Tensor]:
    """Reference PointTransformerWithHeads state_dict -> the ``state_dict``
    of the port's :class:`~treemorph_tpu_torch.models.ptv3.
    PointTransformerWithHeads` ``model``.

    Naming (reference ``Modules/PointTransformerV3/PointTransformerV3.py:
    261-457`` + ``blocks.py``): ``backbone.embedding.stem`` (k=5 spconv +
    BN), ``backbone.enc.enc{s}.down`` SerializedPooling / ``.block{i}``
    Blocks (cpe spconv+linear+LN, norm1/2, attn qkv+proj, mlp fc1/fc2),
    ``backbone.dec.dec{s}.up`` SerializedUnpooling (proj/proj_skip each
    Linear+BN), and the ``semantic_linear``/``offset_linear`` MLP heads.
    """
    t_back = _child_names(model.backbone)
    params: dict = {"backbone": {}}
    stats: dict = {"backbone": {}}
    bp, bs = params["backbone"], stats["backbone"]

    bp["embedding"] = {
        "kernel": _subm_kernel(
            sd["backbone.embedding.stem.conv.weight"], flip_kernel
        ),
        "MaskedBatchNorm_0": _bn_params(
            sd, "backbone.embedding.stem.norm"
        ),
    }
    bs["embedding"] = {
        "MaskedBatchNorm_0": _bn_stats(sd, "backbone.embedding.stem.norm")
    }

    def block(ref):
        p = {
            "cpe": {
                "kernel": _subm_kernel(
                    sd[f"{ref}.cpe.0.weight"], flip_kernel
                ),
                "bias": np.asarray(sd[f"{ref}.cpe.0.bias"], np.float32),
                "Dense_0": _dense(
                    sd[f"{ref}.cpe.1.weight"], sd[f"{ref}.cpe.1.bias"]
                ),
                "LayerNorm_0": _ln(sd, f"{ref}.cpe.2"),
            },
            "norm1": _ln(sd, f"{ref}.norm1.0"),
            "attn": {
                "qkv": _dense(
                    sd[f"{ref}.attn.qkv.weight"],
                    sd.get(f"{ref}.attn.qkv.bias"),
                ),
                "proj": _dense(
                    sd[f"{ref}.attn.proj.weight"],
                    sd[f"{ref}.attn.proj.bias"],
                ),
            },
            "norm2": _ln(sd, f"{ref}.norm2.0"),
            "mlp": {
                "Dense_0": _dense(
                    sd[f"{ref}.mlp.0.fc1.weight"],
                    sd[f"{ref}.mlp.0.fc1.bias"],
                ),
                "Dense_1": _dense(
                    sd[f"{ref}.mlp.0.fc2.weight"],
                    sd[f"{ref}.mlp.0.fc2.bias"],
                ),
            },
        }
        if f"{ref}.attn.rpe.rpe_table" in sd:
            p["attn"]["rpe_table"] = np.asarray(
                sd[f"{ref}.attn.rpe.rpe_table"], np.float32
            )
        return p

    for name in t_back:
        if name.startswith("enc") and "_block" in name:
            s, i = name.replace("enc", "").split("_block")
            ref = f"backbone.enc.enc{s}.block{i}"
            bp[name] = block(ref)
        elif name.startswith("dec") and "_block" in name:
            s, i = name.replace("dec", "").split("_block")
            ref = f"backbone.dec.dec{s}.block{i}"
            bp[name] = block(ref)
        elif name.endswith("_down"):
            s = name[3:-5]
            ref = f"backbone.enc.enc{s}.down"
            bp[name] = {
                "proj": _dense(
                    sd[f"{ref}.proj.weight"], sd[f"{ref}.proj.bias"]
                ),
                "norm": _bn_params(sd, f"{ref}.norm.0"),
            }
            bs[name] = {"norm": _bn_stats(sd, f"{ref}.norm.0")}
        elif name.endswith("_up"):
            s = name[3:-3]
            ref = f"backbone.dec.dec{s}.up"
            bp[name] = {
                "proj": _dense(
                    sd[f"{ref}.proj.0.weight"], sd[f"{ref}.proj.0.bias"]
                ),
                "norm": _bn_params(sd, f"{ref}.proj.1"),
                "proj_skip": _dense(
                    sd[f"{ref}.proj_skip.0.weight"],
                    sd[f"{ref}.proj_skip.0.bias"],
                ),
                "norm_skip": _bn_params(sd, f"{ref}.proj_skip.1"),
            }
            bs[name] = {
                "norm": _bn_stats(sd, f"{ref}.proj.1"),
                "norm_skip": _bn_stats(sd, f"{ref}.proj_skip.1"),
            }

    for head, ref in (
        ("semantic_head", "semantic_linear"),
        ("offset_head", "offset_linear"),
    ):
        params[head] = {
            "Dense_0": _dense(sd[f"{ref}.0.weight"], sd[f"{ref}.0.bias"]),
            "MaskedBatchNorm_0": _bn_params(sd, f"{ref}.1"),
            "Dense_1": _dense(sd[f"{ref}.3.weight"], sd[f"{ref}.3.bias"]),
        }
        stats[head] = {"MaskedBatchNorm_0": _bn_stats(sd, f"{ref}.1")}

    return _check_against_model(
        {"params": params, "batch_stats": stats}, model
    )


def _check_against_model(converted, model) -> dict[str, torch.Tensor]:
    """The converted flax tree as the port model's ``state_dict``,
    validated against the model's own (every key present, no extra key,
    every shape equal) and cast to its dtypes; raises on a mismatch."""
    state = flax_to_state_dict(converted)
    own = model.state_dict()
    missing = [k for k in own if k not in state]
    mismatched = [(k, tuple(state[k].shape), tuple(v.shape))
                  for k, v in own.items()
                  if k in state and state[k].shape != v.shape]
    extras = sorted(set(state) - set(own))
    if missing or mismatched or extras:
        raise ValueError(
            f"checkpoint does not match model: missing={missing[:5]} "
            f"shape_mismatch={mismatched[:5]} unexpected={extras[:5]}"
        )
    return {k: state[k].to(v.dtype) for k, v in own.items()}
