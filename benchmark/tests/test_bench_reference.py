"""The plain reference against the port's CPU path at a tiny size: the
same weights and clouds give the same outputs, and the same training
steps."""

import numpy as np
import pytest
import torch

from benchmark.lib import traffic
from benchmark.lib.weights import make_state
from benchmark.reference import treelearn as R
from benchmark.reference import train as T

from conftest import load

CFG = dict(channels=32, num_blocks=3, kernel_size=3, dim_feat=4,
           voxel_size=0.06, engine="gather", conv_dtype="float32")
SPEC = dict(load("benchmark", "traffic", "train_b30.json"), trees=2,
            points_per_tree=2048)


def clouds(seed):
    rng = traffic.stream(seed, 1)
    return [traffic.labeled_tree(sk, rng, SPEC)[0]
            for sk in traffic.skeletons(SPEC)]


def port_inputs(cs):
    data = np.concatenate(cs)
    n = len(cs[0])
    return (torch.tensor(data[:, :3]), torch.tensor(data[:, 7:11]),
            torch.arange(len(cs)).repeat_interleave(n).int(),
            torch.ones(len(data), dtype=torch.bool))


def port_model(state, engine="gather"):
    from treemorph_tpu_torch.models.treelearn import TreeLearn

    model = TreeLearn(batch_size=2, voxel_capacity=8192,
                      **dict(CFG, engine=engine))
    model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_the_port(train):
    cs = clouds(2**31 + 3)
    state = make_state(R.state_specs(CFG), 5, "cpu", random_stats=True)
    out = port_model(state).train(train)(*port_inputs(cs))
    assert int(out["dropped_voxels"]) == 0
    batch = R.cloud_batch(cs, CFG, 0.05, "cpu")
    sem, off = R.forward(state, batch["structure"], train)
    for mine, theirs in ((sem, out["semantic_prediction_logits"]),
                         (off, out["offset_predictions"])):
        scale = theirs.abs().max()
        assert (mine - theirs).abs().max() <= 1e-5 * scale


def test_state_names_are_the_port_s():
    state = make_state(R.state_specs(CFG), 0, "cpu")
    model = port_model(state)
    assert set(model.state_dict()) == set(state)
    params = {n for n, _ in model.named_parameters()}
    assert params == {n for n in state if R.is_parameter(n)}


def test_training_steps_match_the_port():
    """Three steps of the port's harness (f32 gather engine) and of the
    reference from the same weights, batch by batch: the compared numbers
    read round-off."""
    from treemorph_tpu_torch.data.treeset import TreeSample, make_padded_batch
    from treemorph_tpu_torch.train import families, harness

    state = make_state(R.state_specs(CFG), 9, "cpu")
    model = port_model(state)
    ts = harness.TrainState(model, harness.make_optimizer(model, 1e-3))
    step = harness.make_train_step(*families.treelearn_family())
    names = {p: n for n, p in model.named_parameters()}
    batches, losses, grads = [], [], None
    for t in range(3):
        cs = clouds(100 + t)
        batches.append(cs)
        samples = []
        for c in cs:
            length = np.linalg.norm(c[:, 3:6], axis=1)
            samples.append(TreeSample(c[:, :3], c[:, 7:11], c[:, 3:6],
                                      (length > 0.05).astype(np.int32),
                                      length <= 0.05, "t"))
        b = harness.to_device(make_padded_batch(samples), "cpu")
        ts, metrics = step(ts, b, 0.01, torch.Generator().manual_seed(t))
        losses.append(float(metrics["loss"]))
        if grads is None:
            grads = {names[p]: s["exp_avg"] / 0.1
                     for p, s in ts.optimizer.state.items()}
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainable = [n for n in state if R.is_parameter(n)]
    with T.exact_float32():
        ref = T.train_steps(
            state, trainable,
            [R.cloud_batch(cs, CFG, 0.05, "cpu") for cs in batches],
            lambda p, b: R.batch_loss(p, b), 0.01, 1e-3)
    gaps = T.gaps({"losses": losses, "grads": grads, "params": after},
                  ref, state)
    assert gaps["loss"] < 1e-5
    assert gaps["grad"] < 1e-4
    # Adam divides by each element's own gradient scale, so elements whose
    # gradients are round-off move by round-off amplified
    assert gaps["update"] < 1e-2


PTV3_SMALL = dict(enc_depths=(1, 1, 2), enc_channels=(16, 32, 64),
                  enc_num_head=(2, 2, 4), enc_patch_size=(128,) * 3,
                  dec_depths=(1, 1), dec_channels=(16, 32),
                  dec_num_head=(2, 2), dec_patch_size=(128,) * 2)


@pytest.mark.parametrize("train", [True, False])
def test_ptv3_forward_matches_the_port(train):
    """PTv3 at small widths over two trees of 1,024 points: the frozen
    copy draws the same order permutations and drop-path masks from the
    step's generator, and gives the port's outputs."""
    from treemorph_tpu_torch.data.treeset import PaddedBatch
    from treemorph_tpu_torch.models.ptv3 import PointTransformerWithHeads
    from treemorph_tpu_torch.train import families

    from benchmark.reference import ptv3 as P

    cfg = dict(dim_feat=4, voxel_size=0.02, **PTV3_SMALL)
    spec = dict(SPEC, points_per_tree=1024)
    rng = traffic.stream(5, 1)
    cs = [traffic.labeled_tree(sk, rng, spec)[0]
          for sk in traffic.skeletons(spec)]
    state = make_state(P.state_specs(cfg), 3, "cpu", random_stats=True)
    model = PointTransformerWithHeads(use_feats=True, **cfg)
    model.load_state_dict(state, strict=True)
    coords, feats, bid, valid = port_inputs(cs)
    n = len(cs[0])
    batch = PaddedBatch(coords.reshape(2, n, 3), feats.reshape(2, n, 4),
                        torch.zeros(2, n, 3), torch.zeros(2, n, dtype=int),
                        valid.reshape(2, n), valid.reshape(2, n))
    forward, _ = families.ptv3_family()
    out = forward(model, batch, train, torch.Generator().manual_seed(7))
    sem, off, _ = P.forward(state, cfg, coords, feats, bid, valid, train,
                            torch.Generator().manual_seed(7))
    for mine, theirs in ((sem, out["semantic_prediction_logits"]),
                         (off, out["offset_predictions"])):
        assert (mine - theirs).abs().max() <= 1e-5 * theirs.abs().max()


STAGE2 = dict(k_init=10, max_iterations=10, min_height=0.0,
              min_points=12000)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_stage_2_matches_the_port(engine):
    """The pipeline's upsampling, on its device engine (an approximate
    k-NN over z-order windows) and its host engine (an exact k-NN), holds
    to the reference's definition: every point kept, one exact midpoint per
    original a round, the partners among the originals' nearest (exactly
    so on the host engine)."""
    from treemorph_tpu_torch.pipeline.upsample import upsample

    from benchmark.reference import upsample as U

    cloud = np.random.default_rng(1).normal(size=(3000, 3)).astype(
        np.float32) + np.float32(40.0)
    dense = upsample(cloud, engine=engine, device="cpu", **STAGE2)
    got = U.readings(cloud, dense, 7, "cpu", **STAGE2)
    assert got["upsampled"] == 0.0 and got["midpoints"] == 0.0
    limit = load("benchmark", "configs", "treelearn-band-bf16.json")[
        "serve"]["limits"]["partner_rank"]
    assert got["partner_rank"] <= (1.0 if engine == "host" else limit)


def test_the_reference_upsampler_and_its_control():
    """The definition run reads sound; one precision lower (bfloat16) it
    fails every stage-2 number. The cloud is as dense as a scanned stem
    (points some millimetres apart, 40 m from the origin)."""
    from benchmark.reference import upsample as U

    cloud = np.random.default_rng(2).normal(0.0, 0.1, size=(2000, 3)).astype(
        np.float32) + np.float32(40.0)
    gen = torch.Generator().manual_seed(3)
    dense = U.upsample(cloud, gen, "cpu", **STAGE2)
    assert len(dense) == 2000 * 6
    got = U.readings(cloud, dense, 7, "cpu", **STAGE2)
    assert got == {"upsampled": 0.0, "midpoints": 0.0,
                   "partner_rank": pytest.approx(got["partner_rank"])}
    assert got["partner_rank"] <= 1.0
    low = U.readings(cloud, U.upsample(cloud, gen, "cpu", torch.bfloat16,
                                       **STAGE2), 7, "cpu", **STAGE2)
    assert low["upsampled"] > 0 and low["midpoints"] == 1.0
    assert low["partner_rank"] > 3 * got["partner_rank"]
