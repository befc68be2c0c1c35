"""The port's TreeLearn against the JAX package's, with converted weights.

A narrow model (channels 8; two levels, or one where the JAX side runs the
Pallas band kernel in interpret mode) gets its variables in flax's own
layout (traced once with ``jax.eval_shape``) with values drawn from numpy
as flax's initializers draw them; its BN parameters and statistics are
perturbed so no BN is the identity, and the variables go through the weight
bridge into the port. Both forwards then see the same inputs (JAX with
exact lookups, ``verify_coords=True``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.evaluation.model_loaders import build_model as jbuild
from treemorph_tpu_torch.models import TreeLearn, flax_to_state_dict

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, padded_inputs, t,
)

SMALL = dict(channels=8, num_blocks=2, dim_feat=4, voxel_size=0.02,
             kernel_size=3)


def make_jax_model(engine, conv_dtype, num_blocks, kernel_size=3):
    return jbuild("treelearn", engine=engine, conv_dtype=conv_dtype,
                  verify_coords=True, channels=SMALL["channels"],
                  num_blocks=num_blocks, kernel_size=kernel_size)


@functools.lru_cache(maxsize=None)
def flax_layout(num_blocks, kernel_size=3):
    """Shapes of the small model's flax variables (traced, not compiled;
    they do not depend on the engine)."""
    model = make_jax_model("gather", "float32", num_blocks, kernel_size)
    n = 256
    return jax.eval_shape(
        lambda key: model.init(
            key, jnp.zeros((n, 3)), jnp.zeros((n, 4)),
            jnp.zeros(n, jnp.int32), jnp.ones(n, bool), train=False,
        ),
        jax.random.key(0),
    )


def flax_init(seed, num_blocks, kernel_size=3):
    """Variables in flax's layout, drawn from numpy like flax's
    initializers: fan-in normals for conv kernels and shortcuts,
    Glorot-uniform hidden Dense kernels, N(0, 0.01) final Dense kernels,
    zero biases, BN scale 1 and statistics (0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        shape, name = spec.shape, path[-1]
        if name == "kernel" and path[-2].startswith("Dense_"):
            if path[-2] == "Dense_0":
                lim = np.sqrt(6.0 / (shape[0] + shape[1]))
                return rng.uniform(-lim, lim, shape).astype(np.float32)
            return rng.normal(0, 0.01, shape).astype(np.float32)
        if name in ("kernel", "shortcut", "down_kernel", "up_kernel"):
            fan_in = np.prod(shape[:-1])
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return np.full(shape, fill, np.float32)

    def walk(tree, path=()):
        return {
            k: walk(v, path + (k,)) if hasattr(v, "items")
            else leaf(path + (k,), v)
            for k, v in tree.items()
        }

    return walk(flax_layout(num_blocks, kernel_size))


def jax_model_and_variables(engine, conv_dtype, seed=0, num_blocks=2,
                            kernel_size=3):
    """The JAX model and a fresh perturbed copy of its variables."""
    return (
        make_jax_model(engine, conv_dtype, num_blocks, kernel_size),
        perturb(flax_init(seed, num_blocks, kernel_size), seed),
    )


def perturb(variables, seed):
    """BN scale/bias and running statistics drawn from numpy; the heads'
    final layers scaled up so logits and offsets are O(1)."""
    rng = np.random.default_rng(seed + 100)

    def walk(tree, fn, path=()):
        return {
            k: walk(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), np.asarray(v))
            for k, v in tree.items()
        }

    def params(path, v):
        if path[-1] == "scale":
            return rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        if path[-1] == "bias" and "Dense_1" not in path:
            return rng.normal(0, 0.2, v.shape).astype(np.float32)
        if "Dense_1" in path and path[-1] == "kernel":
            return (v * 50).astype(np.float32)
        return v

    def stats(path, v):
        if path[-1] == "mean":
            return rng.normal(0, 0.3, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    return {
        "params": walk(dict(variables["params"]), params),
        "batch_stats": walk(dict(variables["batch_stats"]), stats),
    }


def port_model(variables, engine, conv_dtype, num_blocks=2):
    model = TreeLearn(engine=engine, conv_dtype=conv_dtype,
                      **dict(SMALL, num_blocks=num_blocks))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.eval()


def balance_noise_head(variables, logits):
    """Set the semantic head's final bias at the median logit margin of
    ``logits`` (the port's, on the test cloud), so both classes occur and
    the argmax comparison means something."""
    margin = float(np.median(logits[:, 1] - logits[:, 0]))
    variables["params"]["semantic_head"]["Dense_1"]["bias"] = np.array(
        [0.0, -margin], np.float32
    )


def both_forwards(engine, conv_dtype, n=2900, pad=172, num_blocks=2):
    jmodel, variables = jax_model_and_variables(
        engine, conv_dtype, num_blocks=num_blocks
    )
    c, f, b, v = padded_inputs(7, n, pad)
    with torch.inference_mode():
        logits = port_model(variables, engine, conv_dtype, num_blocks)(
            t(c), t(f), t(b), t(v)
        )["semantic_prediction_logits"].numpy()[v]
    balance_noise_head(variables, logits)
    out_j = jax.jit(
        lambda var, *a: jmodel.apply(var, *a, train=False)
    )(variables, jnp.asarray(c), jnp.asarray(f), jnp.asarray(b),
      jnp.asarray(v))
    with torch.inference_mode():
        out_t = port_model(variables, engine, conv_dtype, num_blocks)(
            t(c), t(f), t(b), t(v)
        )
    return out_j, out_t, v


def test_weight_bridge_covers_every_parameter():
    _, variables = jax_model_and_variables("gather", "float32")
    sd = flax_to_state_dict(variables)
    model = TreeLearn(**SMALL)
    assert set(sd) == set(model.state_dict())
    bn = variables["batch_stats"]["backbone"]["output_norm"]
    np.testing.assert_array_equal(
        sd["backbone.output_norm.running_var"].numpy(), bn["var"]
    )
    dense = variables["params"]["offset_head"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["offset_head.Dense_0.weight"].numpy(), dense.T
    )


def test_gather_engine_f32_forward_matches_jax():
    """f32 end to end: offsets and logits to 1e-4 (sum order only)."""
    out_j, out_t, v = both_forwards("gather", "float32")
    for key in ("offset_predictions", "semantic_prediction_logits"):
        np.testing.assert_allclose(
            out_t[key].numpy(), out_j[key], rtol=1e-4, atol=1e-4
        )
    np.testing.assert_array_equal(
        out_t["point_to_voxel"].numpy(), out_j["point_to_voxel"]
    )
    assert int(out_t["dropped_points"]) == int(out_j["dropped_points"])
    assert int(out_t["dropped_voxels"]) == int(out_j["dropped_voxels"])
    assert np.abs(out_j["offset_predictions"][v]).mean() > 0.05


def test_band_engine_bf16_forward_matches_jax():
    """bf16 band engine (one level, so the JAX side's interpret-mode
    Pallas kernel stays cheap): the same bf16 roundings on both sides, so
    the outputs differ by sum order amplified through the net (2e-2
    absolute on O(1) outputs), and the noise head's argmax agrees on
    >= 99.9 % of the points."""
    out_j, out_t, v = both_forwards("band", "bfloat16", n=1500, pad=36,
                                    num_blocks=1)
    np.testing.assert_allclose(
        out_t["offset_predictions"].numpy(), out_j["offset_predictions"],
        rtol=2e-2, atol=2e-2,
    )
    lt = out_t["semantic_prediction_logits"].numpy()[v]
    lj = np.asarray(out_j["semantic_prediction_logits"])[v]
    np.testing.assert_allclose(lt, lj, rtol=2e-2, atol=2e-2)
    agree = (lt.argmax(1) == lj.argmax(1)).mean()
    assert agree >= 0.999, agree
    assert 0.3 < (lj.argmax(1) == 1).mean() < 0.7  # both classes occur


def test_engines_not_ported_raise():
    """An engine the JAX package does not have raises; every engine it has
    builds and serves, on the gather engine's weights (pencil and z-pack
    share its parameter names) within 1e-5 of its outputs' scale (the
    engines' parity with JAX: ``test_torch_engines.py``)."""
    with pytest.raises(ValueError, match="unknown TreeLearn engine"):
        TreeLearn(engine="tiles", **SMALL)
    with pytest.raises(ValueError, match="brick_impl"):
        TreeLearn(engine="brick", brick_impl="pallas", **SMALL)
    _, variables = jax_model_and_variables("gather", "float32")
    c, f, b, v = padded_inputs(7, 1500, 36)
    with torch.inference_mode():
        want = port_model(variables, "gather", "float32")(
            t(c), t(f), t(b), t(v))["offset_predictions"].numpy()
        for engine in ("zpack", "pencil"):
            got = port_model(variables, engine, "float32")(
                t(c), t(f), t(b), t(v))["offset_predictions"].numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        brick = TreeLearn(engine="brick", **SMALL).reset_parameters(
            torch.Generator().manual_seed(0)).eval()
        names = set(brick.state_dict())
        assert "backbone.unet.block0.conv0" in names
        assert "backbone.unet.block0.SubMConv_0.kernel" not in names
        out = brick(t(c), t(f), t(b), t(v))["offset_predictions"]
        assert np.isfinite(out.numpy()).all()
