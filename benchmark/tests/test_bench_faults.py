"""A run of the harness with its timed path broken underneath comes out
not correct: the look for a chip is skipped and the rest of a run driven
on the CPU at a tiny size, once for each fault the cell can have on one
chip (one chip has no exchange between chips). Each fault also reads three
times what a sound run reads, in some compared number."""

import pytest
import torch

from benchmark.lib import checks, program, serve_loop, train_loop

TRAIN, SERVE = "treelearn.train.b30", "treelearn.serve.trees"
SERVE_SIZE = dict(pool=2, points_min=4096, points_max=8192, sample=2,
                  sample_within=2, warmup=1)


def run_train(tiny, monkeypatch, family_steps=None, train_step=None):
    ctx = tiny(TRAIN)
    if family_steps is not None:
        monkeypatch.setattr(program, "family_steps", family_steps)
    if train_step is not None:
        monkeypatch.setattr(program.port("train.harness"), "make_train_step",
                            train_step)
    return train_loop.run(ctx)["checks"]


def run_serve(tiny, monkeypatch, serve_cloud=None):
    ctx = tiny(SERVE, **SERVE_SIZE)
    ctx.seconds = 1.0
    if serve_cloud is not None:
        monkeypatch.setattr(program, "serve_cloud", serve_cloud)
    return serve_loop.run(ctx)["checks"]


def read(checks_):
    return {k: v for k, (v, _) in checks_.items()}


@pytest.fixture(scope="module")
def sound():
    """Sound runs' numbers at the tests' size (bf16 convs on the CPU)."""
    from conftest import tiny_context

    with pytest.MonkeyPatch.context() as mp:
        return {"train": read(run_train(tiny_context, mp)),
                "serve": read(run_serve(tiny_context, mp))}


def far_over(fault: dict, sound_values: dict) -> bool:
    return any(v > 3 * sound_values[k] for k, v in fault.items())


def test_sound_runs_are_correct(sound):
    for kind in ("train", "serve"):
        assert all(v >= 0 for v in sound[kind].values())


def test_a_step_that_returns_its_state_unchanged(tiny, monkeypatch, sound):
    def unchanged(forward_fn, loss_fn, *args, **kwargs):
        def step(state, batch, lr, generator=None):
            with torch.no_grad():
                loss, parts = loss_fn(
                    forward_fn(state.model, batch, True, generator), batch)
            return state, {"loss": loss, **parts}
        return step

    got = run_train(tiny, monkeypatch, train_step=unchanged)
    assert not checks.passed(got)
    assert got["update"][0] == pytest.approx(1.0)
    assert far_over(read(got), sound["train"])


def test_half_the_batch_left_out(tiny, monkeypatch, sound):
    real = program.family_steps

    def half(family):
        forward_fn, loss_fn = real(family)

        def loss_on_half(output, batch):
            kept = batch.mask_valid.clone()
            kept[kept.shape[0] // 2:] = False
            return loss_fn(output, batch._replace(mask_valid=kept))
        return forward_fn, loss_on_half

    got = run_train(tiny, monkeypatch, family_steps=half)
    assert not checks.passed(got)
    assert far_over(read(got), sound["train"])


def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch, sound):
    predictor = program.port("evaluation.model_loaders").Predictor
    real = predictor._forward

    def altered(self, *arrays):
        out = dict(real(self, *arrays))
        out["offset_predictions"] = out["offset_predictions"].clone()
        out["offset_predictions"][:16] += 0.05
        return out

    monkeypatch.setattr(predictor, "_forward", altered)
    got = run_serve(tiny, monkeypatch)
    assert not checks.passed(got)
    assert far_over(read(got), sound["serve"])


def test_the_noise_decision_ignored(tiny, monkeypatch, sound):
    """The noise forward runs, and every point is kept all the same."""
    real = program.serve_cloud

    class KeepAll:
        def __init__(self, model):
            self.model = model

        def __getattr__(self, name):
            return getattr(self.model, name)

        def predict_flat(self, *arrays):
            out = dict(self.model.predict_flat(*arrays))
            logits = out["semantic_prediction_logits"]
            out["semantic_prediction_logits"] = torch.stack(
                [logits.abs().sum(1) + 1, logits[:, 1]], dim=1)
            return out

    def keep_all(cloud, family, offset_model, noise_model, *args):
        return real(cloud, family, offset_model, KeepAll(noise_model), *args)

    got = run_serve(tiny, monkeypatch, serve_cloud=keep_all)
    assert not checks.passed(got)
    assert got["refined"][0] > 0


def test_a_midpoint_altered_where_it_is_produced(tiny, monkeypatch, sound):
    upsample = program.port("pipeline.upsample")
    real = upsample.upsample_device

    def altered(*args, **kwargs):
        dense = real(*args, **kwargs).copy()
        dense[-16:] += 1e-4
        return dense

    monkeypatch.setattr(upsample, "upsample_device", altered)
    got = run_serve(tiny, monkeypatch)
    assert not checks.passed(got)
    assert far_over(read(got), sound["serve"])


def test_half_of_each_cloud_left_out(tiny, monkeypatch, sound):
    real = program.serve_cloud

    def half(cloud, *args, **kwargs):
        refined, dense, s1, s2 = real(cloud[: len(cloud) // 2], *args,
                                      **kwargs)
        return refined, dense, s1, s2

    got = run_serve(tiny, monkeypatch, serve_cloud=half)
    assert not checks.passed(got)
