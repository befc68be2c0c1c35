"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference run on the same inputs once the window has
closed and the program's state is freed.

Each number is returned beside its limit, ``{name: [value, limit]}``; a
limit comes from the configuration's ``limits`` (set from sound runs of
the program and from the control, ``PERF.md`` gives the readings). A run is
correct when every number is at or under its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import rounding as ref_rounding
from ..reference import train as ref_train
from ..reference import upsample as ref_upsample


def reference_steps(ctx, start: dict, clouds: list, step_seeds: list,
                    control: str | None = None, moments=None) -> dict:
    """The plain reference's steps (:func:`benchmark.reference.train.
    train_steps`) from ``start`` (and AdamW's ``moments``, default fresh)
    over ``clouds`` (``clouds[t]`` those of step ``t``) under the step
    generators' seeds (a PTv3 step draws its order permutations and
    drop-path masks from its generator); with ``control`` (a name of
    ``benchmark.reference.rounding.CONTROLS``) one precision lower."""
    ref, cfg = ctx.reference, ctx.config
    precision, tf32 = ref_rounding.CONTROLS.get(
        control, (ref_rounding.EXACT, False))
    trainable = [n for n, _, _ in ref.state_specs(cfg["model"])
                 if ref.is_parameter(n)]
    with ref_train.exact_float32(tf32):
        batches = [ref.cloud_batch(c, cfg["model"],
                                   ctx.traffic["noise_distance"], ctx.device)
                   for c in clouds]
        for batch, step_seed in zip(batches, step_seeds):
            batch["step_seed"] = step_seed
        return ref_train.train_steps(
            start, trainable, batches,
            lambda params, batch: ref.batch_loss(params, batch, precision),
            cfg["train"]["lr"], cfg["train"]["weight_decay"], moments)


#: the numbers compared on each checked step
STEP_NUMBERS = ("loss", "grad", "update", "grad_diff")


def training(ctx, start: dict, losses: list, first_grads: dict,
             after: dict, clouds: list, step_seeds: list,
             window: dict | None = None) -> dict:
    """A training cell's readings (:func:`benchmark.reference.train.gaps`),
    the program's checked steps against the reference's; :func:`limited`
    picks the compared ones. With ``window`` (one step the window ran,
    :func:`benchmark.lib.train_loop.window_step`), that step against the
    reference's one step from the program's state before it: each of
    ``STEP_NUMBERS`` is the worse of the two, and the window step's own
    are kept as ``window_<name>``."""
    reference = reference_steps(ctx, start, clouds, step_seeds)
    out = ref_train.gaps({"losses": losses, "grads": first_grads,
                          "params": after}, reference, start)
    if window is not None:
        theirs = reference_steps(ctx, window["start"], [window["clouds"]],
                                 [window["step_seed"]],
                                 moments=window["moments"])
        mine = ref_train.gaps({"losses": [window["loss"]],
                               "grads": window["grads"],
                               "params": window["params"]},
                              theirs, window["start"])
        for k in STEP_NUMBERS:
            out[f"window_{k}"] = mine[k]
            out[k] = max(out[k], mine[k])
    return out


def control_training(ctx, start: dict, clouds: list,
                     step_seeds: list) -> dict:
    """The same readings, the configuration's control in the program's
    place."""
    reference = reference_steps(ctx, start, clouds, step_seeds)
    lower = reference_steps(ctx, start, clouds, step_seeds,
                            ctx.config["control"])
    return ref_train.gaps(lower, reference, start)


def serve_outputs(ctx, weights: list, cloud, precision=None, tf32=False):
    """The reference's offsets (offset model) and noise logits (noise
    model) of every point of ``cloud``."""
    ref, model_cfg = ctx.reference, ctx.config["model"]
    precision = precision or ref_rounding.EXACT
    with ref_train.exact_float32(tf32), torch.no_grad():
        return [ref.serve_forward(w, cloud, model_cfg, ctx.device,
                                  precision)[k]
                for w, k in zip(weights, (1, 0))]


def relative_gap(mine, theirs) -> float:
    """The largest gap over ``theirs``' largest magnitude; inf where the
    shapes differ."""
    if mine.shape != theirs.shape:
        return math.inf
    return float((mine - theirs).abs().max() / theirs.abs().max())


def serving(ctx, weights: list, kept: dict) -> dict:
    """A serving cell's numbers over the requests drawn for the check
    (``kept``: request -> cloud, refined cloud, upsampled cloud, and the
    offset and noise model's recorded forwards), each the worst over them:

    - ``offsets``, ``logits``: the offset model's offsets and the noise
      model's logits against the reference's, their largest gap over the
      reference's largest magnitude;
    - ``refined``: the refined cloud against the points moved by the
      recorded offsets and filtered by the recorded logits, exact;
    - ``upsampled``, ``midpoints``, ``partner_rank``: the upsampled cloud
      held to the reference upsampler's definition, from the refined
      cloud (:func:`benchmark.reference.upsample.readings`)."""
    values = {"offsets": 0.0, "logits": 0.0, "refined": 0.0,
              "upsampled": 0.0, "midpoints": 0.0, "partner_rank": 0.0}
    if not kept:
        values = {k: math.inf for k in values}
    for i, (cloud, refined, dense, rec_off, rec_noise) in kept.items():
        n = len(cloud)
        off_p = rec_off[-1]["offset_predictions"][:n].float()
        logit_p = rec_noise[-1]["semantic_prediction_logits"][:n].float()
        off_r, logit_r = serve_outputs(ctx, weights, cloud)
        keep_p = logit_p.argmax(dim=1) == 0
        if logit_p.shape != logit_r.shape or off_p.shape != off_r.shape:
            values = {k: math.inf for k in values}
            continue
        moved = (cloud[:, :3] + off_p.cpu().numpy())[keep_p.cpu().numpy()]
        worst = {
            "offsets": relative_gap(off_p, off_r),
            "logits": relative_gap(logit_p, logit_r),
            "refined": (float(np.abs(moved - refined).max())
                        if moved.shape == refined.shape else math.inf),
            **stage2_readings(ctx, refined, dense, i),
        }
        values = {k: max(values[k], worst[k]) for k in values}
    return limited(values, ctx.config["serve"]["limits"])


def stage2_args(ctx) -> dict:
    return {k: v for k, v in ctx.traffic["stage2"].items()
            if k != "use_only_original_points"}


def stage2_readings(ctx, refined, dense, request: int) -> dict:
    """:func:`benchmark.reference.upsample.readings` of one request's
    upsampled cloud, its sample drawn from the seed and the request."""
    return ref_upsample.readings(refined, dense, ctx.seed + request,
                                 ctx.device, **stage2_args(ctx))


def control_serving(ctx, weights: list, clouds: dict) -> dict:
    """The numbers of :func:`serving`, the configuration's control in the
    program's place over ``clouds`` (request -> cloud): stage 1 one
    precision lower; stage 2 on the largest cloud (one round), the
    reference upsampler in bfloat16 (below the pipeline's float32) fed
    the reference's refined cloud."""
    precision, tf32 = ref_rounding.CONTROLS[ctx.config["control"]]
    values, exact = {"offsets": 0.0, "logits": 0.0}, {}
    for i, cloud in clouds.items():
        exact[i] = serve_outputs(ctx, weights, cloud)
        off_c, logit_c = serve_outputs(ctx, weights, cloud, precision, tf32)
        worst = {"offsets": relative_gap(off_c, exact[i][0]),
                 "logits": relative_gap(logit_c, exact[i][1])}
        values = {k: max(values[k], worst[k]) for k in values}
    i = max(clouds, key=lambda j: len(clouds[j]))
    off_r, logit_r = exact[i]
    keep = (logit_r.argmax(dim=1) == 0).cpu().numpy()
    refined = (clouds[i][:, :3] + off_r.cpu().numpy())[keep]
    generator = torch.Generator(device=ctx.device)
    generator.manual_seed(ctx.seed)
    dense = ref_upsample.upsample(refined, generator, ctx.device,
                                  torch.bfloat16, **stage2_args(ctx))
    return dict(values, **stage2_readings(ctx, refined, dense, i))


def limited(values: dict, limits: dict) -> dict:
    """``{name: [value, limit]}`` of each reading that has a limit."""
    return {k: [values[k], limits[k]] for k in limits if k in values}


def passed(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())
