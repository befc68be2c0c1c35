"""The ``serve`` traffic's loop: one client sends cloud after cloud through
the pipeline's stage 1 and stage 2, each as soon as the last one's result
is back (a closed loop), as ``exec_pipeline`` refines the clouds of a
directory before its host QSM fit (stage 3, off here).

Set-up makes the mix's pool of clouds from the seed, builds the offset and
the noise model of the configuration with the seed's weights (random
BatchNorm statistics: they serve in eval mode), and serves the pool's
largest cloud ``warmup`` times. The window then serves request after
request, each the pool's next cloud turned and moved anew, until
``--seconds`` have passed; a request is timed from the call to the
upsampled host array. The requests drawn for the check keep the two
forwards' outputs, their refined and upsampled clouds; those the window
did not reach are served after it, untimed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import train as ref_train
from . import checks, program, traffic
from .host import HostWatch
from .trace import TracedPart, synchronize
from .weights import make_state


def weights_of(ctx, dev, pool: list) -> list:
    """The offset and the noise model's weights, made from the seed. The
    noise model's last bias is ``noise_bias`` on both classes, less, on
    the noise class, the ``1 - noise_share`` quantile of the reference's
    margins (noise logit less kept logit) over the pool's smallest cloud:
    the noise head drops about that share of every cloud, as a trained
    head drops a scan's outliers."""
    specs = ctx.reference.state_specs(ctx.config["model"])
    weights = [make_state(specs, ctx.seed + k, dev, random_stats=True)
               for k in (0, 1)]
    serve = ctx.config["serve"]
    bias = torch.full((2,), float(serve["noise_bias"]), device=dev)
    weights[1]["semantic_head.Dense_1.bias"] = bias
    with ref_train.exact_float32(), torch.no_grad():
        logits = ctx.reference.serve_forward(
            weights[1], min(pool, key=len), ctx.config["model"], dev)[0]
    margin = (logits[:, 1] - logits[:, 0]).double()
    bias[1] -= float(torch.quantile(margin, 1.0 - serve["noise_share"]))
    return weights


def models(ctx, dev, pool: list):
    """The offset and noise predictors, and the weights each was given."""
    family, model_cfg = ctx.config["family"], ctx.config["model"]
    weights = weights_of(ctx, dev, pool)
    out = []
    for w in weights:
        model = program.build_model(family, model_cfg, 1)
        model.load_state_dict(w, strict=True)
        out.append(program.predictor(family, model, dev))
    return out, weights


def check_sample(spec: dict, seed: int, pool: list) -> set:
    """The requests whose outputs the check compares: ``sample`` drawn
    from the seed among the first ``sample_within``, and the first request
    of the pool's largest cloud."""
    drawn = traffic.stream(seed, 6).choice(
        spec["sample_within"], spec["sample"], replace=False)
    return set(drawn.tolist()) | {int(np.argmax([len(c) for c in pool]))}


def run(ctx) -> dict:
    spec, seed, dev = ctx.traffic, ctx.seed, ctx.device
    family = ctx.config["family"]
    if dev.type == "cuda":
        program.build_kernels()
    pool = traffic.serving_pool(spec, seed)
    (offset_model, noise_model), weights = models(ctx, dev, pool)
    stage2 = spec["stage2"]

    def serve(cloud):
        return program.serve_cloud(cloud, family, offset_model, noise_model,
                                   stage2, dev)

    largest = max(pool, key=len)
    for _ in range(spec["warmup"]):
        serve(largest)
    setup_s = time.perf_counter() - ctx.t_start

    sample = check_sample(spec, seed, pool)
    requests = traffic.stream(seed, 7)
    latency, stage1_s, stage2_s, sizes, kept = [], [], [], [], {}

    def next_request():
        """Serve the next request; keep its outputs if it is drawn for
        the check. Returns the request's size, refined size and stage
        seconds."""
        i = len(sizes)
        cloud = traffic.request(pool, i, requests)
        for model in (offset_model, noise_model):
            model.recorded = [] if i in sample else None
        refined, dense, s1, s2 = serve(cloud)
        sizes.append(len(cloud))
        if i in sample:
            kept[i] = (cloud, refined, dense, offset_model.recorded,
                       noise_model.recorded)
        return len(refined), s1, s2

    traced = TracedPart(ctx.recorder(), ctx.trace_seconds, ctx.seconds,
                        program.launches, lambda: synchronize(dev))
    host = HostWatch()
    traced.start()
    host.start()
    t0 = time.perf_counter()
    refined_points = 0
    while True:
        t_req = time.perf_counter()
        n_refined, s1, s2 = next_request()
        latency.append(time.perf_counter() - t_req)
        stage1_s.append(s1)
        stage2_s.append(s2)
        refined_points += n_refined
        last = time.perf_counter() - t0 >= ctx.seconds
        traced.done(len(latency), last)
        if last:
            break
    window_s = time.perf_counter() - t0
    host_readings = host.stop()
    served = list(sizes)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    # requests drawn for the check that the window did not reach are
    # served now, untimed
    while len(sizes) <= max(sample):
        next_request()
    del offset_model, noise_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {
        "setup_s": setup_s, "window_s": window_s,
        "attempted": len(latency), "failed": 0,
        "memory_peak_bytes": memory_peak,
        "host": host_readings,
        "kept_share": refined_points / sum(served),
        "end_to_end": {
            "serve_points_per_s": sum(served) / window_s,
            "serve_cloud_ms_p95": 1000.0 * float(
                np.quantile(latency, 0.95, method="linear")),
        },
    }
    t_check = time.perf_counter()
    out["checks"] = checks.serving(ctx, weights, kept)
    out["phases"] = {"check_s": time.perf_counter() - t_check}
    if traced.trace is not None:
        h, n = traced.head_steps, traced.steps
        replay = traffic.stream(seed, 7)
        # both forwards of each cloud, the offset and the noise model's
        layers = [2 * ctx.reference.cloud_layers(
            traffic.request(pool, i, replay), ctx.config["model"], dev)
            for i in range(h + n)]
        out["layer_input"] = {
            "kind": "serve", "trace": traced.trace,
            "window_s": traced.window_s, "steps": n,
            "launched": traced.launched, "step_layers": layers[h:],
            # the untraced head, for the host-clock readers
            "head_s": traced.head_s, "stage1_s": stage1_s[:h],
            "stage2_s": stage2_s[:h], "head_layers": layers[:h],
        }
    return out
