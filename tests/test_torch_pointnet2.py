"""The port's PointNet2 against the JAX package's, with converted weights:
the forward at depths 2, 5 and 6 (depth 6 groups its first level at three
scales), the weight bridge, ``raster_assignments`` and the rasterized
stage 1 (``predict_rasterized``), and the entry points' device default.

Variables come in flax's own layout (traced with ``jax.eval_shape``) with
values drawn from numpy, every BatchNorm moved off the identity, and go
through ``flax_to_state_dict`` into the port. Inputs are rasters of a
synthetic tree's scan (``test_torch_sampling.raster_batch``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.evaluation import model_loaders as jloaders
from treemorph_tpu.models.pointnet2 import PointNet2 as JPointNet2
from treemorph_tpu.pipeline import predict as jpredict
from treemorph_tpu_torch.evaluation.model_loaders import (
    FAMILY_DEFAULTS,
    Predictor,
    build_model,
    load_model,
)
from treemorph_tpu_torch.models import PointNet2, flax_to_state_dict
from treemorph_tpu_torch.pipeline import predict as tpredict
from treemorph_tpu_torch.pipeline.run import run_pipeline
from treemorph_tpu_torch.train.checkpoints import MODEL_FILE

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)
from test_torch_sampling import raster_batch, tree_points


@functools.lru_cache(maxsize=None)
def flax_layout(depth):
    model = JPointNet2(depth=depth, dim_feat=4)
    n = 64
    return jax.eval_shape(
        lambda key: model.init(key, jnp.zeros((1, n, 3)),
                               jnp.zeros((1, n, 4)),
                               jnp.ones((1, n), bool), train=False),
        jax.random.key(0),
    )


def flax_variables(depth, seed=0):
    """The depth's variables in flax's layout: Dense kernels N(0,
    1/fan_in), biases N(0, 0.1), BatchNorm scale U(0.7, 1.3), bias N(0,
    0.2), running mean N(0, 0.3), variance U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        shape, name = spec.shape, path[-1]
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "bias":
            std = 0.2 if path[-2].startswith("BatchNorm") else 0.1
            return rng.normal(0, std, shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.3, shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)  # var

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if hasattr(v, "items")
                else leaf(path + (k,), v) for k, v in tree.items()}

    return walk(flax_layout(depth))


def port_model(variables, depth):
    model = PointNet2(depth=depth, dim_feat=4)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("depth", [2, 5, 6])
def test_forward_matches_jax(depth):
    """Eval forward, f32: backbone features, logits and offsets within
    1e-4 of their scale (sum order of the MLPs' matmuls; sampling indices
    are identical, test_torch_sampling.py)."""
    coords, feats, valid = raster_batch(b=2, n=1280)
    variables = flax_variables(depth)
    jmodel = JPointNet2(depth=depth, dim_feat=4)
    want = jax.jit(lambda v, c, f, m: jmodel.apply(v, c, f, m, train=False))(
        variables, jnp.asarray(coords), jnp.asarray(feats),
        jnp.asarray(valid))
    with torch.inference_mode():
        got = port_model(variables, depth)(t(coords), t(feats), t(valid))
    for key in ("backbone_feats", "semantic_prediction_logits",
                "offset_predictions"):
        w = np.asarray(want[key])
        scale = np.abs(w).max()
        assert scale > 0.1, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=key)


@pytest.mark.parametrize("depth", [2, 5, 6])
def test_every_flax_leaf_lands_on_a_torch_key(depth):
    """The bridge's keys are exactly the port's state_dict at each depth,
    shapes included (Dense kernels transposed)."""
    variables = flax_variables(depth)
    sd = flax_to_state_dict(variables)
    model = PointNet2(depth=depth, dim_feat=4)
    ref = model.state_dict()
    assert set(sd) == set(ref)
    for key, value in sd.items():
        assert value.shape == ref[key].shape, key
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves


def test_raster_assignments_match_jax():
    """Keys, order and point indices identical, with overlapping rasters
    (stride half the raster)."""
    pts = tree_points(1)[::3]
    for size, stride in ((1.0, 1.0), (1.0, 0.5)):
        got = tpredict.raster_assignments(pts, size, stride)
        want = jpredict.raster_assignments(pts, size, stride)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_predict_rasterized_matches_jax():
    """Overlapping 1 m rasters (stride 0.5, so points average up to 8
    rasters), minibatches of 4 with the last one padded: refined points
    within 1e-4 of the offsets' scale, and the same points kept by the
    noise head (its final bias puts about half the points in each class)."""
    pts = tree_points(2)
    rng = np.random.default_rng(3)
    cloud = np.zeros((3000, 11), np.float32)
    cloud[:, :3] = pts[rng.choice(len(pts), 3000, replace=False)]
    cloud[:, 7:11] = rng.normal(size=(3000, 4))
    variables = flax_variables(5, seed=4)
    noise_vars = flax_variables(5, seed=5)
    jmodel = JPointNet2(depth=5, dim_feat=4)
    kw = dict(raster_size=1.0, stride=0.5, minibatch_size=4, bucket=512)
    offsets = tpredict.predict_rasterized(
        cloud, Predictor("pointnet2", port_model(variables, 5), "cpu"),
        denoise=False, device="cpu", **kw)
    want = jpredict.predict_rasterized(
        cloud, jloaders.Predictor("pointnet2", jmodel, variables),
        denoise=False, **kw)
    scale = np.abs(want - cloud[:, :3]).max()
    assert scale > 0.01  # offsets, averaged over rasters: real work
    np.testing.assert_allclose(offsets, want, rtol=0, atol=1e-4 * scale)

    # balance the noise head at the median logit margin of the port's
    # rasters (recorded on a first run), so both classes occur
    margins = []

    class Recording(Predictor):
        def predict_padded(self, coords, feats, valid):
            out = super().predict_padded(coords, feats, valid)
            lg = out["semantic_prediction_logits"][valid.to(self.device)]
            margins.append((lg[:, 1] - lg[:, 0]).numpy())
            return out

    tpredict.predict_rasterized(
        cloud, noise_model=Recording("pointnet2", port_model(noise_vars, 5),
                                     "cpu"),
        predict_offset=False, device="cpu", **kw)
    margin = float(np.median(np.concatenate(margins)))
    noise_vars["params"]["semantic_head"]["Dense_1"]["bias"] = (
        noise_vars["params"]["semantic_head"]["Dense_1"]["bias"]
        + np.array([margin / 2, -margin / 2], np.float32))
    kept = tpredict.predict_rasterized(
        cloud, noise_model=Predictor("pointnet2", port_model(noise_vars, 5),
                                     "cpu"),
        predict_offset=False, device="cpu", **kw)
    kept_j = jpredict.predict_rasterized(
        cloud, noise_model=jloaders.Predictor("pointnet2", jmodel,
                                              noise_vars),
        predict_offset=False, **kw)
    np.testing.assert_array_equal(kept, kept_j)
    assert 0.1 < len(kept) / len(cloud) < 0.9


def test_pipeline_routes_pointnet2(tmp_path, monkeypatch):
    """``make_predictions`` sends the family to ``predict_rasterized`` with
    the pipeline's raster defaults (1 m rasters, stride 1, minibatches of
    60), and ``load_model`` serves the port's own PointNet2 checkpoints
    (``P{n}`` directories holding ``model.pt``)."""
    seen = {}

    def fake(cloud, offset_model, noise_model, predict_offset, denoise,
             **kw):
        seen.update(kw)
        return cloud[:, :3]

    monkeypatch.setattr(tpredict, "predict_rasterized", fake)
    cloud = np.zeros((10, 3), np.float32)
    tpredict.make_predictions(cloud, "pointnet2", device="cpu")
    assert seen == dict(raster_size=1.0, stride=1.0, minibatch_size=60,
                        device="cpu")

    model = build_model("pointnet2", device="cpu", seed=1, depth=2)
    (tmp_path / "P3").mkdir()
    (tmp_path / "P3.metadata.json").write_text('{"depth": 2}')
    torch.save(model.state_dict(), tmp_path / "P3" / MODEL_FILE)
    loaded = load_model("pointnet2", str(tmp_path), device="cpu")
    assert set(loaded) == {"O_P3"}
    for key, value in loaded["O_P3"].model.state_dict().items():
        torch.testing.assert_close(value, model.state_dict()[key])


def test_build_model_defaults_and_seeded_init():
    """The pipeline's PointNet2 (depth 5, 4 features); one seed gives one
    set of weights; each head's output layer starts near zero."""
    assert FAMILY_DEFAULTS["pointnet2"] == dict(
        depth=5, dim_feat=4, use_coords=True, use_features=True)
    a = build_model("pointnet2", device="cpu", seed=3)
    b = build_model("pointnet2", device="cpu", seed=3)
    assert not a.training and a.depth == 5
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    w = a.offset_head.Dense_1.weight.detach()
    assert float(w.abs().max()) < 0.06 and float(w.std()) > 0.005
    hidden = a.SetAbstraction_0.PointwiseMLP_0.Dense_0.weight.detach()
    assert float(hidden.abs().max()) <= 2 * (1 / 7) ** 0.5 / 0.8796 + 1e-6


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cloud = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    model = build_model("pointnet2", device="cpu", depth=2)
    calls = [
        lambda: build_model("pointnet2"),
        lambda: Predictor("pointnet2", model),
        lambda: tpredict.predict_rasterized(cloud),
        lambda: run_pipeline({"general": {"input_dir": str(tmp_path),
                                          "output_dir": str(tmp_path)},
                              "stage1": {"model_type": "pointnet2"}}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Predictor("pointnet2", model, "cpu").device.type == "cpu"
