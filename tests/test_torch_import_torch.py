"""The port's importer of the reference system's ``.pt`` checkpoints
(``train/import_torch.py``, ``scripts/import_checkpoint.py``) against the
JAX package's.

The reference's checkpoints are not in the repository, so the state dicts
are made here with its key names and shapes: TreeLearn's as the JAX
package's own import test builds one (``tests/test_import_torch.py``), and
every family's from a port model's weights through ``chip_smoke.
reference_state_dict`` (the inverse naming the chip script uses too). Each
goes through the JAX converter and then ``flax_to_state_dict``, and
through the port's converter: the tensors must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.train import import_torch as jimport
from treemorph_tpu_torch.evaluation.model_loaders import (
    Predictor,
    build_model,
    load_model,
)
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.pipeline.predict import _pad_flat
from treemorph_tpu_torch.scripts import import_checkpoint
from treemorph_tpu_torch.train import import_torch as timport

from chip_smoke import reference_state_dict
from test_import_torch import _synthetic_treelearn_sd
from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401

#: a PTv3 of two levels at the parity tests' tiny widths
#: (``tests/test_torch_ptv3.py``), one block each: every kind of module
#: (stem, blocks, pooling, unpooling, heads)
TINY = dict(enc_depths=(1, 1), enc_channels=(16, 32), enc_num_head=(2, 2),
            enc_patch_size=(64, 64), dec_depths=(1,), dec_channels=(16,),
            dec_num_head=(2,), dec_patch_size=(64,))

#: per family: the port model's settings (the JAX model's are the same)
CONFIGS = {
    "treelearn": dict(channels=8, num_blocks=2),
    "pointnet2": dict(depth=2),
    "pointtransformerv3": TINY,
}
CONVERTERS = {
    "treelearn": (jimport.convert_treelearn, timport.convert_treelearn),
    "pointnet2": (jimport.convert_pointnet2, timport.convert_pointnet2),
    "pointtransformerv3": (jimport.convert_ptv3, timport.convert_ptv3),
}


def flax_template(model):
    """The flax variables' layout of the port ``model`` (leaves as
    ``jax.ShapeDtypeStruct``): the inverse of ``flax_to_state_dict``, whose
    agreement with the JAX models' own ``init`` trees the port's model
    tests hold (``strict=True`` loads of converted JAX variables). Built
    without tracing a JAX model: the JAX converters only check their
    output's structure and shapes against it."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(value.shape)
        if leaf in ("running_mean", "running_var"):
            kind, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and len(shape) == 2:
            kind, leaf, shape = "params", "kernel", shape[::-1]
        elif leaf == "weight":
            kind, leaf = "params", "scale"
        else:
            kind = "params"
        node = tree[kind]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return tree


def port_model(family, seed=1):
    return build_model(family, device="cpu", seed=seed, **CONFIGS[family])


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def via_jax(family, sd, model, **kw):
    variables = CONVERTERS[family][0](sd, flax_template(model), **kw)
    return flax_to_state_dict(jax.device_get(variables))


@pytest.mark.parametrize("flip_kernel", [False, True])
def test_treelearn_converter_matches_jax(flip_kernel):
    """The JAX import test's synthetic TreeLearn state dict (channels 8,
    two levels, the 2C -> C tail shortcuts), with and without the mirrored
    offset order."""
    sd = _synthetic_treelearn_sd(np.random.default_rng(0), num_blocks=2)
    model = port_model("treelearn")
    got = timport.convert_treelearn(sd, model, flip_kernel=flip_kernel)
    assert_same_state(got, via_jax("treelearn", sd, model,
                                   flip_kernel=flip_kernel))
    model.load_state_dict(got)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_converter_matches_jax_and_inverts_the_reference_naming(family):
    """A port model's weights under the reference's names convert, through
    either package, back to exactly those weights."""
    model = port_model(family)
    sd = reference_state_dict(family, model)
    got = CONVERTERS[family][1](sd, model)
    assert_same_state(got, via_jax(family, sd, model))
    assert_same_state(got, model.state_dict())


def test_ptv3_rpe_table_converts_as_jax():
    """A PTv3 with RPE: the reference's ``attn.rpe.rpe_table`` of every
    block converts, through either package, to the port's ``rpe_table``
    (3 * 25 rows at K = 64, one column per head)."""
    model = build_model("pointtransformerv3", device="cpu", seed=2,
                        enable_rpe=True, **TINY)
    sd = reference_state_dict("pointtransformerv3", model)
    tables = [k for k in sd if k.endswith("attn.rpe.rpe_table")]
    assert len(tables) == 3 and sd[tables[0]].shape == (75, 2)
    got = timport.convert_ptv3(sd, model)
    assert_same_state(got, via_jax("pointtransformerv3", sd, model))
    assert_same_state(got, model.state_dict())


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_structural_mismatch_raises(family):
    """Checked against the port model's own state dict: a missing
    module, or a width the model does not have, raises."""
    model = port_model(family)
    sd = reference_state_dict(family, model)
    bigger = {"treelearn": dict(channels=8, num_blocks=3),
              "pointnet2": dict(depth=3),
              "pointtransformerv3": dict(TINY, enc_channels=(16, 48))}
    other = build_model(family, device="cpu", **bigger[family])
    with pytest.raises((ValueError, KeyError)):
        CONVERTERS[family][1](sd, other)
    key = next(k for k in sd if k.endswith("running_var"))
    broken = dict(sd, **{key: np.ones(sd[key].shape[0] + 1, np.float32)})
    with pytest.raises(ValueError, match="shape_mismatch"):
        CONVERTERS[family][1](broken, model)


def test_permute_spconv_axes_matches_jax():
    rng = np.random.default_rng(0)
    sd = {"conv.weight": rng.normal(size=(4, 3, 3, 3, 2)).astype(np.float32),
          "linear.weight": rng.normal(size=(4, 8)).astype(np.float32)}
    for axes in ("xyz", "zyx", "yzx"):
        got = timport.permute_spconv_axes(sd, axes)
        want = jimport.permute_spconv_axes(sd, axes)
        for key in sd:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("family", ["treelearn", "pointnet2"])
def test_import_checkpoint_reproduces_the_forward(family, tmp_path):
    """A reference ``.pt`` (wrapped as ``{"model": state_dict}``) through
    ``import_checkpoint`` and ``load_model`` on the CPU: the same outputs,
    bit for bit, as the model whose weights it holds."""
    cfg = {"treelearn": dict(channels=8, num_blocks=2),
           "pointnet2": dict(depth=2)}[family]
    model = build_model(family, device="cpu", seed=3, **cfg)
    sd = reference_state_dict(family, model)
    pt = tmp_path / "reference.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               pt)
    flags = (["--channels", "8", "--num_blocks", "2"]
             if family == "treelearn" else ["--depth", "2"])
    out = import_checkpoint.main([family, str(pt),
                                  str(tmp_path / "offset" / "Model_O_P3"),
                                  *flags, "--device", "cpu"])
    assert out.endswith("Model_O_P3")
    loaded = load_model(family, str(tmp_path / "offset"), device="cpu")
    assert sorted(loaded) == ["O_P3"]
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.3, size=(600, 3)).astype(np.float32)
    feats = rng.normal(size=(600, 4)).astype(np.float32)
    outs = []
    for predictor in (Predictor(family, model, "cpu"), loaded["O_P3"]):
        if family == "pointnet2":
            res = predictor.predict_padded(
                torch.from_numpy(pts[None]), torch.from_numpy(feats[None]),
                torch.ones((1, 600), dtype=torch.bool))
        else:
            res = predictor.predict_flat(*_pad_flat(pts, feats,
                                                    device="cpu")[:4])
        outs.append(res["offset_predictions"])
    assert torch.equal(outs[0], outs[1])
