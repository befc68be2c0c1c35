"""The port's pipeline against the JAX package's, stage by stage and end to
end: fixtures, stage 1 (``predict_single`` with converted weights), stage 2
(host and device upsamplers), stage 3 (``fit_qsm``'s CSV, byte for byte)
and ``run_pipeline`` from a raw ``.npy`` to the cylinder CSV.
"""

import importlib

import numpy as np
import pytest
import torch

from treemorph_tpu import fixtures as jfix
from treemorph_tpu.evaluation.model_loaders import Predictor as JPredictor
from treemorph_tpu.pipeline import predict as jpredict
from treemorph_tpu.pipeline.qsm import QSMParams as JParams
from treemorph_tpu.pipeline.qsm import fit_qsm as jfit
from treemorph_tpu_torch import fixtures as tfix
from treemorph_tpu_torch.evaluation.model_loaders import Predictor
from treemorph_tpu_torch.ops.serialization import z_order_encode
from treemorph_tpu_torch.pipeline import predict as tpredict
from treemorph_tpu_torch.pipeline.qsm import QSMParams, fit_qsm
from treemorph_tpu_torch.pipeline.run import run_pipeline

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, surface_cloud,
)
from test_torch_treelearn import (
    balance_noise_head,
    jax_model_and_variables,
    port_model,
)

# both pipeline packages re-export a function under the module's name
jup = importlib.import_module("treemorph_tpu.pipeline.upsample")
tup = importlib.import_module("treemorph_tpu_torch.pipeline.upsample")


def test_fixtures_are_bit_equal():
    qj = jfix.synthetic_qsm(n_branches=3, rng=np.random.default_rng(3))
    qt = tfix.synthetic_qsm(n_branches=3, rng=np.random.default_rng(3))
    assert list(qj.columns) == qt.columns
    for col in qj.columns:
        a = qj[col].to_numpy()
        assert a.dtype == qt[col].dtype, col
        np.testing.assert_array_equal(qt[col], a)
    for fn, kw in [
        ("synthetic_tree_cloud", dict(points_per_m2=300,
                                      outlier_fraction=0.05)),
        ("qsm_noise_cloud", dict(density=80.0)),
    ]:
        qsm = qj if fn == "qsm_noise_cloud" else None
        out_j = getattr(jfix, fn)(
            **({"qsm": qsm} if qsm is not None else {}), **kw,
            rng=np.random.default_rng(11),
        )
        out_t = getattr(tfix, fn)(
            **({"qsm": qt} if qsm is not None else {}), **kw,
            rng=np.random.default_rng(11),
        )
        out_j = out_j[0] if isinstance(out_j, tuple) else out_j
        out_t = out_t[0] if isinstance(out_t, tuple) else out_t
        np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(
        tfix.synthetic_cylinder_cloud(500, rng=np.random.default_rng(2)),
        jfix.synthetic_cylinder_cloud(500, rng=np.random.default_rng(2)),
    )


@pytest.fixture(scope="module")
def raw_cloud():
    """A whole small synthetic tree in the labeled (N, 11) layout with
    random features."""
    rng = np.random.default_rng(21)
    qsm = tfix.synthetic_qsm(n_branches=2, rng=rng)
    pts, _ = tfix.synthetic_tree_cloud(
        qsm=qsm, points_per_m2=300, noise_scale=0.004, rng=rng
    )
    feats = rng.normal(size=(len(pts), 4)).astype(np.float32)
    cloud = np.zeros((len(pts), 11), np.float32)
    cloud[:, :3] = pts
    cloud[:, 7:11] = feats
    return cloud


@pytest.fixture(scope="module")
def models(raw_cloud):
    """One small one-level gather-engine f32 TreeLearn in both packages,
    serving as offset and noise model. Its offset head keeps flax's
    N(0, 0.01) final layer (small offsets leave a tree to fit); its noise
    head's bias is set at the median logit margin over this cloud, so
    about half the points are dropped."""
    jmodel, variables = jax_model_and_variables(
        "gather", "float32", seed=3, num_blocks=1
    )
    head = variables["params"]["offset_head"]["Dense_1"]
    head["kernel"] = (head["kernel"] / 50).astype(np.float32)

    def port():
        model = port_model(variables, "gather", "float32", num_blocks=1)
        return Predictor("treelearn", model, "cpu")

    coords, f, b, v, n = tpredict._pad_flat(
        raw_cloud[:, :3], raw_cloud[:, 7:11], device="cpu"
    )
    balance_noise_head(variables, port().predict_flat(coords, f, b, v)[
        "semantic_prediction_logits"][:n].numpy())
    return JPredictor("treelearn", jmodel, variables), port()


@pytest.fixture(scope="module")
def stage1_jax(models, raw_cloud):
    jpred, _ = models
    return jpredict.predict_single(raw_cloud, jpred, jpred)


def test_predict_single_matches_jax(models, raw_cloud, stage1_jax):
    """Same points kept; offset-refined coordinates to 1e-4 (f32)."""
    _, tpred = models
    out = tpredict.predict_single(raw_cloud, tpred, tpred, device="cpu")
    assert 0.3 < len(out) / len(raw_cloud) < 0.7  # the head drops half
    assert out.shape == stage1_jax.shape
    np.testing.assert_allclose(out, stage1_jax, rtol=1e-4, atol=1e-4)


def test_host_upsampler_is_exact():
    pts = surface_cloud(5, 1500)
    out_j = jup.upsample(pts, min_points=4000, engine="host",
                         rng=np.random.default_rng(1))
    out_t = tup.upsample(pts, min_points=4000, engine="host",
                         rng=np.random.default_rng(1), device="cpu")
    np.testing.assert_array_equal(out_t, out_j)


def test_device_upsampler_layout_and_neighbors():
    """The random choice differs (jax.random vs torch.Generator); the
    layout, the per-round counts and the candidate rule may not: every
    round-0 midpoint is (q + nbr) / 2 with nbr among the k nearest usable
    candidates of q's z-order window."""
    pts = surface_cloud(6, 1500)
    kw = dict(min_points=4000, min_height=0.05, bucket=1024)
    out_j = jup.upsample_device(pts, rng=np.random.default_rng(2), **kw)
    out_t = tup.upsample_device(pts, rng=np.random.default_rng(2),
                                device="cpu", **kw)
    assert out_t.shape == out_j.shape
    below = (pts[:, 2] < pts[:, 2].min() + 0.05).sum()
    n0 = len(pts) - below
    np.testing.assert_array_equal(out_t[: len(pts)], out_j[: len(pts)])
    rounds = -(-(4000 - n0) // n0)  # n0 * (1 + rounds) >= min_points
    assert len(out_t) - len(pts) == rounds * n0  # every query, every round

    above = out_t[below: len(pts)]
    nbr = 2 * out_t[len(pts): len(pts) + n0] - above  # round 0
    w, k = 64, 10
    grid = np.clip((above - above.min(0)) * 1000, 0, 65535).astype(np.int64)
    code = z_order_encode(torch.from_numpy(grid)).numpy()
    order = np.argsort(code, kind="stable")
    pos = np.searchsorted(code[order], code)
    cap = -(-n0 // 1024) * 1024 * (rounds + 1)  # padded corpus rows
    for i in range(0, n0, 37):
        base = int(np.clip(pos[i] - w, 0, cap - 2 * w))
        rows = order[base: base + 2 * w]
        rows = rows[rows < n0]  # padding rows sort last and are unusable
        d2 = ((above[rows] - above[i]) ** 2).sum(1)
        d2 = np.sort(d2[d2 > 1e-18])
        got = ((nbr[i] - above[i]) ** 2).sum()
        assert got <= d2[min(k, len(d2)) - 1] * (1 + 1e-4) + 1e-12


def test_fit_qsm_csv_is_byte_identical(tmp_path):
    qsm = jfix.synthetic_qsm(n_branches=3, rng=np.random.default_rng(3))
    cloud, _ = jfix.synthetic_tree_cloud(
        qsm=qsm, points_per_m2=1500, noise_scale=0.004,
        outlier_fraction=0.02, rng=np.random.default_rng(5),
    )
    df, _, _, _ = jfit(cloud, params=JParams(seed=0),
                       output_base=str(tmp_path / "jax"))
    table, _, _, _ = fit_qsm(cloud, params=QSMParams(seed=0),
                             output_base=str(tmp_path / "port"))
    assert len(table) == len(df) > 20
    assert (tmp_path / "port_cylinders.csv").read_bytes() == (
        tmp_path / "jax_cylinders.csv"
    ).read_bytes()


def test_run_pipeline_end_to_end(tmp_path, models, raw_cloud, stage1_jax):
    """Raw .npy -> cylinder CSV through the port. Stage 1 is held to JAX
    ``predict_single``; stage 3 to JAX ``fit_qsm`` on the port's own
    stage-2 cloud (byte-identical CSV)."""
    _, tpred = models
    inp = tmp_path / "in"
    inp.mkdir()
    np.save(inp / "tree.npy", raw_cloud)
    cfg = {
        "general": {
            "input_dir": str(inp), "output_dir": str(tmp_path / "out"),
            "save_model_predictions": True, "save_upsampling": True,
            "save_qsm_cyl_csv": True, "cloud_save_type": "npy",
        },
        "stage1": {"predict_offset": True, "denoise": True,
                   "model_type": "treelearn"},
        "stage2": {"upsampling": True, "k_init": 10, "max_iterations": 10,
                   "min_height": 0.0, "use_only_original_points": True,
                   "min_points": 3 * len(raw_cloud)},
        "stage3": {"qsm_fitting": True,
                   "qsm_params": {"seed": 0, "clustering_type": "angular"}},
    }
    results = run_pipeline(cfg, tpred, tpred, device="cpu")
    assert len(results) == 1 and results[0]["cylinders"] > 0
    out = tmp_path / "out" / "treelearn"
    stage1 = np.load(out / "tree_pred_denoised.npy")
    np.testing.assert_allclose(stage1, stage1_jax, rtol=1e-4, atol=1e-4)
    stage2 = np.load(out / "tree_supsamp.npy")
    assert len(stage2) >= 3 * len(raw_cloud)
    np.testing.assert_array_equal(stage2[: len(stage1)], stage1)
    jfit(stage2, params=JParams.from_dict(cfg["stage3"]["qsm_params"]),
         output_base=str(tmp_path / "jax"))
    assert (out / "tree_qsm_depth_cylinders.csv").read_bytes() == (
        tmp_path / "jax_cylinders.csv"
    ).read_bytes()


#: the config ``tests/test_scripts.py::TestPipelineCLI`` dumps with
#: ``yaml.safe_dump`` (its directories here stand for tmp paths)
SCRIPTS_CFG = {
    "general": {
        "input_dir": "/tmp/data root/clouds", "output_dir": "/tmp/out",
        "save_model_predictions": False, "save_upsampling": False,
        "save_qsm_cyl_ply": False, "save_qsm_sphere_ply": False,
        "save_qsm_cyl_csv": True, "cloud_save_type": "npy",
    },
    "stage1": {"predict_offset": False, "denoise": False,
               "model_type": "no_model"},
    "stage2": {"upsampling": True, "k_init": 5, "max_iterations": 2,
               "min_height": 0.0, "use_only_original_points": False,
               "min_points": 3000},
    "stage3": {"qsm_fitting": True, "qsm_verbose": False,
               "qsm_debug": False,
               "qsm_params": {"eps_deg": 20, "min_samples": 5, "seed": 0}},
}


@pytest.mark.parametrize("source", ["shipped", "scripts_dump", "json"])
def test_config_reader_matches_safe_load(tmp_path, source):
    """``load_config`` reads ``configs/pipeline_config.yaml``, the test
    scripts' ``yaml.safe_dump`` of a config (with ``model_dirs`` and a
    null entry added) and a JSON config as ``yaml.safe_load`` / ``json``
    read them; the port imports no YAML library."""
    import json
    import os

    import yaml

    from treemorph_tpu_torch.utils.config import load_config

    if source == "shipped":
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "pipeline_config.yaml")
        want = yaml.safe_load(open(path))
        assert want["model_dirs"]["pointnet2"][0].endswith("offset")
    else:
        want = dict(SCRIPTS_CFG, model_dirs={
            "treelearn": ["saves/treelearn_CV", None],
            "pointnet2": ["saves/pointnet2_CV", "saves/pointnet2_CV"]})
        want["stage2"] = dict(want["stage2"], min_height=-0.25,
                              radius=1.5e-05, label="null", name="it's")
        path = str(tmp_path / ("cfg.json" if source == "json"
                               else "cfg.yaml"))
        with open(path, "w") as f:
            if source == "json":
                json.dump(want, f)
            else:
                yaml.safe_dump(want, f)
    got = load_config(path)
    assert got == want
    assert {k: type(v) for k, v in got["stage2"].items()} == {
        k: type(v) for k, v in want["stage2"].items()}


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",
    "general: {input_dir: in, output_dir: out}\n",
    "dirs: [a, b]\n",
    "flag: yes\n",
    "rate: 1e-5\n",
    "text: |\n  block\n",
    "a: 1\na: 2\n",
])
def test_config_reader_refuses_outside_its_subset(text):
    """Anchors and aliases, flow mappings and sequences, YAML 1.1 bools,
    numbers the YAML versions read differently, block scalars and
    duplicate keys raise rather than being guessed."""
    from treemorph_tpu_torch.utils.config import parse_yaml

    with pytest.raises(ValueError, match="outside the YAML subset"):
        parse_yaml(text)


def test_run_pipeline_from_model_dirs(tmp_path, models, raw_cloud):
    """``run_pipeline`` with no injected model loads the port's
    checkpoints named by ``model_dirs`` (plot 3 first) and writes the same
    cylinder CSV as with the models injected; so does ``python -m
    treemorph_tpu_torch.scripts.exec_pipeline --config cfg.yaml``."""
    import copy

    import yaml

    from treemorph_tpu_torch.scripts import exec_pipeline
    from treemorph_tpu_torch.train import harness
    from treemorph_tpu_torch.train.checkpoints import save_checkpoint

    _, tpred = models
    state = harness.TrainState(tpred.model,
                               harness.make_optimizer(tpred.model))
    meta = dict(model="treelearn", channels=8, num_blocks=1, dim_feat=4,
                voxel_size=0.02, kernel_size=3)
    for role in ("offset", "noise"):
        save_checkpoint(str(tmp_path / role / "P3"), state, meta)
    other = copy.deepcopy(tpred.model)  # another plot's, not taken
    with torch.no_grad():
        other.offset_head.Dense_1.bias.add_(0.5)
    save_checkpoint(str(tmp_path / "offset" / "P5"),
                    harness.TrainState(other, harness.make_optimizer(other)),
                    meta)
    inp = tmp_path / "in"
    inp.mkdir()
    np.save(inp / "tree.npy", raw_cloud)

    def config(out):
        return {
            "general": {"input_dir": str(inp), "output_dir": str(out),
                        "save_qsm_cyl_csv": True},
            "model_dirs": {"treelearn": [str(tmp_path / "offset"),
                                         str(tmp_path / "noise")]},
            "stage1": {"predict_offset": True, "denoise": True,
                       "model_type": "treelearn"},
            "stage2": {"upsampling": False},
            "stage3": {"qsm_fitting": True,
                       "qsm_params": {"seed": 0,
                                      "clustering_type": "angular"}},
        }

    injected = run_pipeline(config(tmp_path / "a"), tpred, tpred,
                            device="cpu")
    loaded = run_pipeline(config(tmp_path / "b"), device="cpu")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config(tmp_path / "c")))
    cli = exec_pipeline.main(["--config", str(cfg_path), "--device", "cpu"])
    assert injected[0]["cylinders"] > 0
    csvs = [(tmp_path / d / "treelearn" / "tree_qsm_depth_cylinders.csv")
            .read_bytes() for d in "abc"]
    assert csvs[0] == csvs[1] == csvs[2]
    assert (injected[0]["points"] == loaded[0]["points"]
            == cli[0]["points"] < len(raw_cloud))
