"""The port's evaluation suite against the JAX package's: NN-distance and
QSM-distance evaluation (``evaluation/nn_eval.py``, ``qsm_eval.py``), the
single-tree diagnostics (``diagnostics.py``), the figures (``plotting/``)
and the ``evaluate`` CLI, on the CPU.

Sizes are the JAX tests' (``tests/test_evaluation.py``,
``tests/test_qsm_eval.py``): synthetic trees of 2 branches at 40 points per
m^2 and a TreeLearn of 2 blocks (channels 8), whose variables are drawn in
flax's layout and go through the weight bridge into the port
(``tests/test_torch_treelearn.py``). The clouds stay under 1,024 points, so
every JAX forward pads to one bucket and compiles once.
"""

import functools
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from treemorph_tpu.data.treeset import TreeDataset as JTreeDataset
from treemorph_tpu.evaluation import diagnostics as jdiag
from treemorph_tpu.evaluation import nn_eval as jnn
from treemorph_tpu.evaluation import qsm_eval as jqsm
from treemorph_tpu.evaluation.model_loaders import Predictor as JPredictor
from treemorph_tpu.pipeline import predict as jpredict
from treemorph_tpu.plotting import figures as jfig
from treemorph_tpu.plotting import qsm_comparison as jcomp
from treemorph_tpu_torch import fixtures as tfix
from treemorph_tpu_torch.data.treeset import TreeDataset
from treemorph_tpu_torch.evaluation import diagnostics as tdiag
from treemorph_tpu_torch.evaluation import nn_eval as tnn
from treemorph_tpu_torch.evaluation import qsm_eval as tqsm
from treemorph_tpu_torch.evaluation.model_loaders import Predictor
from treemorph_tpu_torch.ops.projection import generate_offset_cloud
from treemorph_tpu_torch.pipeline import predict as tpredict
from treemorph_tpu_torch.plotting import figures as tfig
from treemorph_tpu_torch.plotting import qsm_comparison as tcomp
from treemorph_tpu_torch.scripts import evaluate
from treemorph_tpu_torch.utils.table import Table

from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401
from test_torch_treelearn import jax_model_and_variables, port_model

#: the tolerance of ``tests/test_torch_treelearn.py`` (f32 forwards in
#: another sum order)
RTOL = ATOL = 1e-4


def as_frame(table: Table) -> pd.DataFrame:
    return pd.DataFrame({c: table[c] for c in table.columns})


@functools.lru_cache(maxsize=None)
def labeled_tree(seed: int):
    """(labeled (N, 11) cloud, QSM table, raw points) of a synthetic tree
    of 2 branches at 40 points/m^2, labeled by the port on the CPU, with
    ones features (as the JAX package's nn_eval test labels one)."""
    rng = np.random.default_rng(seed)
    qsm = tfix.synthetic_qsm(n_branches=2, rng=rng)
    pts, _ = tfix.synthetic_tree_cloud(qsm=qsm, points_per_m2=40, rng=rng)
    labeled = generate_offset_cloud(pts, qsm, device="cpu")
    labeled = np.concatenate(
        [labeled, np.ones((len(labeled), 4), np.float32)], axis=1)
    assert len(labeled) < 1024
    return labeled, qsm, pts


@functools.lru_cache(maxsize=None)
def predictors():
    """(JAX predictor, port predictor) of one TreeLearn (2 blocks) with the
    same converted weights."""
    jmodel, variables = jax_model_and_variables("gather", "float32", seed=0)
    return (JPredictor("treelearn", jmodel, variables),
            Predictor("treelearn", port_model(variables, "gather", "float32"),
                      "cpu"))


def write_trees(root):
    """Two labeled trees, plots 3 and 4, and their ``plot_{n}.json``."""
    paths = []
    for plot, seed in ((3, 1), (4, 2)):
        path = os.path.join(root, f"{plot}_{seed}_labeled.npy")
        np.save(path, labeled_tree(seed)[0])
        with open(os.path.join(root, f"plot_{plot}.json"), "w") as f:
            json.dump([path], f)
        paths.append(path)
    return paths


def test_nearest_neighbour_distances_match_jax():
    pts = labeled_tree(1)[2]
    np.testing.assert_array_equal(tnn.nearest_neighbour_distances(pts),
                                  jnn.nearest_neighbour_distances(pts))
    for k in (1, 5):
        got, want = (m.nearest_neighbour_distances_k(pts, k)
                     for m in (tdiag, jdiag))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_summaries_and_binned_transform_match_jax():
    rng = np.random.default_rng(0)
    before = rng.uniform(0.001, 0.5, 3000)
    after = 0.3 * before**0.8 * rng.uniform(0.95, 1.05, 3000)
    records = [{"nn_before": before[:1000], "nn_after": after[:1000]},
               {"nn_before": before[1000:], "nn_after": after[1000:]}]
    assert (tnn.summarize_nn_records(records)
            == jnn.summarize_nn_records(records))
    got = tnn.binned_mean_transform(before, after)
    want = jnn.binned_mean_transform(before, after)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and np.isfinite(got[2]).all()


def test_stem_alignment_matches_jax():
    _, qsm, pts = labeled_tree(1)
    frame = as_frame(qsm)
    np.testing.assert_array_equal(tqsm.point_cloud_stem_base_center(pts),
                                  jqsm.point_cloud_stem_base_center(pts))
    np.testing.assert_array_equal(tqsm.qsm_stem_base_center(qsm),
                                  jqsm.qsm_stem_base_center(frame))
    shifted = pts + np.array([0.3, -0.2, 0.1], np.float32)
    got = tqsm.align_qsm_to_cloud(qsm, shifted)
    want = jqsm.align_qsm_to_cloud(frame, shifted)
    assert got.columns == list(want.columns)
    for col in ("startX", "startY", "startZ", "endX", "endY", "endZ"):
        np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=0,
                                   atol=1e-6)


def test_project_on_qsm_and_distance_statistics_match_jax():
    _, qsm, pts = labeled_tree(1)
    refined = pts + np.random.default_rng(0).normal(
        0, 0.01, pts.shape).astype(np.float32)
    got = [tqsm.project_on_qsm(c, qsm, device="cpu") for c in (pts, refined)]
    want = [jqsm.project_on_qsm(c, as_frame(qsm)) for c in (pts, refined)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    stats_t = tqsm.compare_distance_distributions(*got)
    stats_j = jqsm.compare_distance_distributions(*want)
    assert stats_t.keys() == stats_j.keys()
    for key in stats_j:
        assert abs(stats_t[key] - stats_j[key]) <= 1e-6, key
    centers_t, props_t, fit_t = tqsm.log_binned_proportions(got[1])
    centers_j, props_j, fit_j = jqsm.log_binned_proportions(want[1])
    np.testing.assert_allclose(centers_t, centers_j, rtol=1e-6)
    np.testing.assert_allclose(props_t, props_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fit_t, fit_j, rtol=1e-5)


def test_project_clouds_matches_jax(tmp_path):
    labeled, qsm, _ = labeled_tree(2)
    cloud = tmp_path / "4_2.npy"
    np.save(cloud, labeled[:, :3])
    csv = tmp_path / "4_2_qsm.csv"
    qsm.to_csv(str(csv))
    got = tqsm.project_clouds([str(cloud)], [str(csv)], str(tmp_path / "t"),
                              align=True, device="cpu")
    want = jqsm.project_clouds([str(cloud)], [str(csv)],
                               str(tmp_path / "j"), align=True)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == ["4_2_labeled_pred_projected.npy"]
    a, b = np.load(got[0]), np.load(want[0])
    np.testing.assert_allclose(a[:, :6], b[:, :6], rtol=0, atol=1e-5)
    assert (a[:, 6] == b[:, 6]).mean() > 0.99
    np.testing.assert_array_equal(a[:, 7:], b[:, 7:])


def test_nn_eval_with_converted_weights_matches_jax(tmp_path):
    """Each tree goes to its plot's offset model, else the first one (the
    plot-4 tree); the refined clouds and the records agree."""
    paths = write_trees(str(tmp_path))
    jpred, tpred = predictors()
    want = jnn.nn_eval({"O_P3": jpred}, JTreeDataset(
        paths, training=False, process_json=False))
    got = tnn.nn_eval({"O_P3": tpred}, TreeDataset(
        paths, training=False, process_json=False), device="cpu")
    assert [r["path"] for r in got] == [r["path"] for r in want] == paths
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["nn_before"], w["nn_before"])
        np.testing.assert_allclose(g["nn_after"], w["nn_after"], rtol=RTOL,
                                   atol=ATOL)
    cloud = labeled_tree(1)[0]
    refined_t = tpredict.predict_single(cloud, tpred, None, True, False,
                                        device="cpu")
    refined_j = jpredict.predict_single(cloud, jpred, None, True, False)
    assert np.abs(refined_t - cloud[:, :3]).max() > 1e-3  # offsets moved
    np.testing.assert_allclose(refined_t, refined_j, rtol=RTOL, atol=ATOL)


#: the figure writers ``test_model`` calls
DIAGNOSTIC_FIGURES = ("plot_offset_slices", "plot_loglog_nn_comparison",
                      "plot_slice_quadrant", "plot_noise_mask_slice")


def test_test_model_matches_jax(tmp_path, monkeypatch):
    """The same metrics, and figures of the same names drawn from the same
    inputs. The figure writers are replaced (in both packages) by one that
    records the call and touches the file: drawing the 13 figures twice
    takes ~20 s; each port writer draws for real in
    :func:`test_figure_writes_its_file`."""
    calls = {}

    def recorder(package):
        def record(name):
            def write(*args, **kwargs):
                path = next(a for a in (*args, *kwargs.values())
                            if isinstance(a, str) and a.endswith(".png"))
                calls.setdefault(package, []).append(
                    (name, os.path.basename(path), args[:3]))
                open(path, "wb").close()
                return path
            return write
        return record

    for module, package in ((jdiag, "jax"), (tdiag, "port")):
        for name in DIAGNOSTIC_FIGURES:
            monkeypatch.setattr(module, name, recorder(package)(name))
    labeled = labeled_tree(1)[0]
    jpred, tpred = predictors()
    want = jdiag.test_model(jpred, labeled, str(tmp_path / "jax"),
                            name="syn", noise_predictor=jpred)
    got = tdiag.test_model(tpred, labeled, str(tmp_path / "port"),
                           name="syn", noise_predictor=tpred, device="cpu")
    assert got.keys() == want.keys()

    def names(paths):
        return ([os.path.basename(p) for p in paths]
                if isinstance(paths, list) else os.path.basename(paths))

    for key in ("slice_plot", "hist_plot", "knn_plots", "slice_plots",
                "noise_plots"):
        assert names(got[key]) == names(want[key]), key
    assert len(got["slice_plots"]) == len(got["noise_plots"]) >= 3
    for key in tdiag.METRICS:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
    # each figure got the same first arguments (points, labels or
    # distances), within the forwards' tolerance
    assert [c[:2] for c in calls["port"]] == [c[:2] for c in calls["jax"]]
    for (_, _, a_t), (_, _, a_j) in zip(calls["port"], calls["jax"]):
        for x_t, x_j in zip(a_t, a_j):
            np.testing.assert_allclose(np.asarray(x_t, float),
                                       np.asarray(x_j, float), rtol=RTOL,
                                       atol=ATOL)
    masks_t = tdiag.make_noise_prediction(
        tpred, labeled, np.zeros((len(labeled), 3), np.float32),
        device="cpu")
    masks_j = jdiag.make_noise_prediction(
        jpred, labeled, np.zeros((len(labeled), 3), np.float32))
    for m_t, m_j in zip(masks_t, masks_j):
        assert (m_t == m_j).mean() > 0.99


def test_qsm_comparison_helpers_match_jax(tmp_path):
    vals = [0.0, 0.005, 0.05, 0.1, 0.55, 1.0, 1.05, 2.0, np.inf]
    np.testing.assert_array_equal(tcomp.custom_scale(vals),
                                  jcomp.custom_scale(vals))
    assert ([tcomp.custom_label(v) for v in vals]
            == [jcomp.custom_label(v) for v in vals])
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 1.5, 500), rng.uniform(0, 1, 500)
    for got, want in zip(tcomp._binned_mean_std(x, y, tcomp.COMPARISON_BINS),
                         jcomp._binned_mean_std(x, y, jcomp.COMPARISON_BINS)):
        np.testing.assert_array_equal(got, want)
    assert (tcomp.mean_distance_and_error(y)
            == jcomp.mean_distance_and_error(y))
    orig, model = projected_dirs(tmp_path)
    for kw in ({}, {"orig_suffix": "_labeled.npy", "suffix": "_m.npy"}):
        for got, want in zip(
                tcomp.load_pointwise_distance_pairs(orig, model, **kw),
                jcomp.load_pointwise_distance_pairs(orig, model, **kw)):
            assert len(got) > 0
            np.testing.assert_array_equal(got, want)
    assert (tcomp.per_tree_mean_distances(orig, model)
            == jcomp.per_tree_mean_distances(orig, model))
    path = os.path.join(model, "42_1_projected.npy")
    np.testing.assert_array_equal(tcomp.offset_norms_from_file(path),
                                  jcomp.offset_norms_from_file(path))
    assert tcomp.offset_norms_from_file(path + ".missing") is None


def projected_dirs(root):
    """Original and model directories of projected clouds (xyz, offset,
    id), the model's offsets 0.4 of the original's; the model directory
    also holds ``{id}_m.npy`` copies against ``{id}_labeled.npy``
    originals (the reference's trainset pairing)."""
    rng = np.random.default_rng(5)
    orig, model = os.path.join(root, "orig"), os.path.join(root, "model")
    os.makedirs(orig)
    os.makedirs(model)
    for tree in ("42_1", "42_2"):
        n = int(rng.integers(200, 300))
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        off = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
        for d, scale in ((orig, 1.0), (model, 0.4)):
            data = np.concatenate(
                [pts, off * scale, np.zeros((n, 1), np.float32)], axis=1)
            np.save(os.path.join(d, f"{tree}_projected.npy"), data)
        np.save(os.path.join(orig, f"{tree}_labeled.npy"),
                np.load(os.path.join(orig, f"{tree}_projected.npy")))
        np.save(os.path.join(model, f"{tree}_m.npy"),
                np.load(os.path.join(model, f"{tree}_projected.npy")))
    return orig, model


def _figure_cases():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    offs = rng.normal(0, 0.02, size=(300, 3)).astype(np.float32)
    d = rng.lognormal(-3, 1, 300)
    orig = rng.uniform(0.001, 1.5, 600)
    pred = orig * rng.uniform(0.3, 0.6, 600)
    plots = list(rng.choice(["3", "4"], 600))
    bounds = ((-1, 1, -1, 1, -1, 0), (-1, 1, -1, 1, 0, 1))
    qsm = Table({"startX": np.array([0.0, 0.2]), "startY": np.array([0.0,
                 -0.3]), "startZ": np.array([-0.9, 0.1]),
                 "endX": np.array([0.0, 0.4]), "endY": np.array([0.0, -0.1]),
                 "endZ": np.array([0.0, 0.6]), "radius": np.array([0.15,
                                                                  0.05]),
                 "ID": np.array([1, 2])})
    records = [{"nn_before": orig, "nn_after": pred}]
    return {
        "epoch_times": lambda p: tfig.plot_epoch_time_comparison(
            {"treelearn": [12.8, 13.0], "ptv3": [39.0, 39.1]}, p),
        "distance_heatmap": lambda p: tfig.plot_distance_heatmap(pts, d, p),
        "offset_slices": lambda p: tfig.plot_offset_slices(
            pts, offs, offs * 0.9, p, slices=((0, 1), (1, 2))),
        "upsampling": lambda p: tfig.plot_upsampling_visual(
            pts, np.vstack([pts, pts + 0.01]), p),
        "qsm_comparison": lambda p: tcomp.plot_qsm_comparison(
            orig, pred, [0.02], [0.001], [0.01], [0.001], ["U-Net"], p),
        "per_tree": lambda p: tcomp.plot_per_tree_mean_distances(
            [0.3, 0.05], [0.02, 0.01], p),
        "transformation_slices": lambda p: tcomp.plot_transformation_slices(
            pts, offs, p, bounds=bounds, views=("z", "y")),
        "qsm_slices": lambda p: tcomp.plot_qsm_comparison_slices(
            pts, qsm, qsm, p, bounds=bounds, views=("z", "y")),
        "nn_distances": lambda p: tnn.plot_nn_distances(records, p),
        "nn_scaled": lambda p: tnn.plot_nn_distances_scaled(
            orig, pred, p, tree_plots=plots, color_by_plot=True,
            show_scatter=True, show_fit=True),
        "nn_subplots": lambda p: tnn.plot_nn_distances_subplots(
            orig, pred, plots, p),
        "qsm_distances": lambda p: tqsm.plot_qsm_distance_comparison(
            d, d * 0.5, p),
        "loglog_nn": lambda p: tdiag.plot_loglog_nn_comparison(
            d, d * 0.5, float(d.mean()), float(d.mean()) / 2, 1, p),
        "slice_quadrant": lambda p: tdiag.plot_slice_quadrant(
            pts, offs, offs * 0.9, 0.03, bounds[1], d[:100], d[:100] / 2,
            "y", p),
        "noise_mask_slice": lambda p: tdiag.plot_noise_mask_slice(
            pts, offs, d > 0.05, d > 0.1, bounds[0], "z", p),
    }


@pytest.mark.parametrize("name", sorted(_figure_cases()))
def test_figure_writes_its_file(name, tmp_path):
    path = str(tmp_path / f"{name}.png")
    assert _figure_cases()[name](path) == path
    assert os.path.getsize(path) > 1000


def test_qsm_csv_to_ply_reads_quoted_headers(tmp_path):
    _, qsm, _ = labeled_tree(1)
    csv = tmp_path / "qsm.csv"
    qsm.to_csv(str(csv))
    text = csv.read_text().split("\n", 1)
    header = ", ".join(f'"{c}"' for c in text[0].split(","))
    csv.write_text(header + "\n" + text[1])
    ply = tfig.qsm_csv_to_ply(str(csv), str(tmp_path / "qsm.ply"))
    want = jfig.qsm_csv_to_ply(str(csv), str(tmp_path / "jax.ply"))
    # the same mesh; the colours within one step of 255 (pandas' CSV float
    # parser is not round-trip exact, the port's is)
    got, want = (open(p).read().split("end_header\n") for p in (ply, want))
    assert got[0] == want[0]
    n_vert = int(got[0].split("element vertex ")[1].split()[0])
    lines_t, lines_j = (x[1].splitlines() for x in (got, want))
    assert lines_t[n_vert:] == lines_j[n_vert:]  # the faces
    vert_t, vert_j = (np.array([r.split() for r in lines[:n_vert]], float)
                      for lines in (lines_t, lines_j))
    np.testing.assert_allclose(vert_t[:, :3], vert_j[:, :3], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(vert_t[:, 3:], vert_j[:, 3:], rtol=0, atol=1)


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """The CLI's inputs: two plots of labeled trees, a checkpoint
    directory of the port's TreeLearn (``P3/model.pt`` and its metadata),
    a cloud, a refined cloud and the QSM CSV with quoted, space-padded
    headers, and projected-cloud directories."""
    root = tmp_path_factory.mktemp("cli")
    paths = write_trees(str(root))
    tpred = predictors()[1]
    ckpt = root / "treelearn_CV" / "P3"
    ckpt.mkdir(parents=True)
    torch.save(tpred.model.state_dict(), ckpt / "model.pt")
    (root / "treelearn_CV" / "P3.metadata.json").write_text(json.dumps(
        {"model": "treelearn", "channels": 8, "num_blocks": 2,
         "dim_feat": 4, "voxel_size": None}))
    (root / "manifest.json").write_text(json.dumps(paths))
    labeled, qsm, pts = labeled_tree(1)
    np.save(root / "cloud.npy", pts)
    np.save(root / "pred.npy", labeled[:, :6] * np.array(
        [1, 1, 1, 0.5, 0.5, 0.5], np.float32))
    qsm.to_csv(str(root / "qsm.csv"))
    text = (root / "qsm.csv").read_text().split("\n", 1)
    header = ",".join(f' "{c}" ' for c in text[0].split(","))
    (root / "qsm.csv").write_text(header + "\n" + text[1])
    projected_dirs(str(root))
    return root


@pytest.mark.parametrize("command", ["nn", "predict", "qsm-distance",
                                     "qsm-comp", "slices"])
def test_evaluate_cli_runs_on_cpu(command, cli_root, tmp_path, capsys):
    r, out = str(cli_root), str(tmp_path)
    argv = {
        "nn": ["nn", "treelearn", "--data_root", r, "--test_plot", "3",
               "--offset_model_dir", f"{r}/treelearn_CV",
               "--scaled_plot_path", f"{out}/nn_scaled.png",
               "--device", "cpu"],
        "predict": ["predict", "treelearn", "--manifest",
                    f"{r}/manifest.json", "--offset_model_dir",
                    f"{r}/treelearn_CV", "--noise_model_dir",
                    f"{r}/treelearn_CV", "--outputDir", out,
                    "--save_type", "npy", "--device", "cpu"],
        "qsm-distance": ["qsm-distance", "--cloud", f"{r}/cloud.npy",
                         "--pred_cloud", f"{r}/pred.npy", "--qsm_csv",
                         f"{r}/qsm.csv", "--device", "cpu"],
        "qsm-comp": ["qsm-comp", "--orig_dir", f"{r}/orig", "--model_dirs",
                     f"{r}/model", "--plot_path", f"{out}/comp.png",
                     "--per_tree_plot_path", f"{out}/per_tree.png"],
        "slices": ["slices", "--pred_cloud", f"{r}/pred.npy",
                   "--plot_path", f"{out}/slices.png", "--bounds",
                   json.dumps([[-5, 5, -5, 5, 0, 2], [-5, 5, -5, 5, 2, 9]]),
                   "--views", '["z", "y"]', "--orig_qsm", f"{r}/qsm.csv",
                   "--enhanced_qsm", f"{r}/qsm.csv"],
    }[command]
    result = evaluate.main(argv)
    printed = capsys.readouterr().out
    written = [f for f in os.listdir(out)]
    if command == "nn":
        assert result["n_points"] == len(labeled_tree(1)[0])
        assert '"trees": 1' in printed
        assert written == ["nn_scaled.png"]
    elif command == "predict":
        assert sorted(written) == ["3_1_labeled_pred.npy",
                                   "3_1_labeled_pred_denoised.npy",
                                   "4_2_labeled_pred.npy",
                                   "4_2_labeled_pred_denoised.npy"]
    elif command == "qsm-distance":
        labeled, qsm, pts = labeled_tree(1)
        want = jqsm.compare_distance_distributions(
            jqsm.project_on_qsm(pts, as_frame(qsm)),
            jqsm.project_on_qsm(np.load(f"{r}/pred.npy"), as_frame(qsm)))
        for key, value in want.items():
            assert abs(result[key] - value) <= 1e-6, key
        assert written == []
    elif command == "qsm-comp":
        assert result["models"] == ["model"]
        assert result["improvements"][0] > 0
        assert sorted(written) == ["comp.png", "per_tree.png"]
    else:
        assert written == ["slices.png"]
