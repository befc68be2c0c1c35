"""The ``train`` traffic's loop: a closed loop of the port's training steps
at a fixed batch, fed as the training CLI feeds them.

Set-up writes the mix's trees as the CLI's data files under ``TMPDIR``,
builds the model as the CLI builds it (level-0 voxel capacity worked out
from the clouds), loads the seed's weights, and drives the one train state
through its first ``check_steps`` steps with the window's own call and
feed: those steps are the warm-up, and their losses, the first step's
gradient as AdamW holds it (``exp_avg / (1 - beta1)``) and the parameters
after them are what the reference is compared with. The window then
continues the same state: each step reads its batch through
``TreeDataset`` -> ``batch_iterator`` -> ``harness.to_device`` and takes
``train_step`` at a constant learning rate, until ``--seconds`` have
passed; the device is synchronized once, at the end. The window's step
``window_check_step`` (counted from 0) is compared too: the state before
and after it is copied on the device (no synchronization), and the
reference takes that one step from the copy before it.
"""

from __future__ import annotations

import itertools
import shutil
import tempfile
import time

import numpy as np
import torch

from . import checks, program, traffic
from .host import HostWatch
from .trace import TracedPart, synchronize
from .weights import make_state


def feed(port_data, dataset, spec: dict, seed: int):
    """``(tree indices, PaddedBatch)`` of every step, epoch after epoch:
    the CLI's ``batch_iterator`` handed each epoch's generator."""
    n, b = len(dataset), spec["batch_size"]
    for epoch in itertools.count():
        order = traffic.epoch_order(seed, epoch, n)
        batches = port_data.batch_iterator(
            dataset, b, spec["bucket"], shuffle=True,
            rng=traffic.epoch_rng(seed, epoch))
        for i, batch in enumerate(batches):
            yield order[i * b:(i + 1) * b], batch


def run(ctx) -> dict:
    """Set-up, window and check of one run; see the module docstring."""
    data_dir = tempfile.mkdtemp(prefix="bench-train-")
    try:
        return _run(ctx, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def _run(ctx, data_dir: str) -> dict:
    spec, cfg, seed = ctx.traffic, ctx.config, ctx.seed
    model_cfg, family = cfg["model"], cfg["family"]
    dev = ctx.device
    ref = ctx.reference
    if dev.type == "cuda":
        program.build_kernels()
    manifest, paths = traffic.write_training_set(spec, seed, data_dir)
    port_data = program.port("data.treeset")
    harness = program.port("train.harness")
    dataset = port_data.TreeDataset(manifest, training=True,
                                    noise_distance=spec["noise_distance"])
    batch = spec["batch_size"]
    model = program.build_model(family, model_cfg, batch, dataset).to(dev)
    start = make_state(ref.state_specs(model_cfg), seed, dev)
    model.load_state_dict(start, strict=True)
    state = harness.TrainState(model, harness.make_optimizer(
        model, cfg["train"]["weight_decay"]))
    train_step = harness.make_train_step(*program.family_steps(family))
    lr = cfg["train"]["lr"]
    seed_stream = traffic.stream(seed, 3)
    drawn = []

    def step_generator():
        drawn.append(int(seed_stream.integers(2**62)))
        return torch.Generator().manual_seed(drawn[-1])

    batches = feed(port_data, dataset, spec, seed)
    names = {p: n for n, p in model.named_parameters()}
    checked, check_trees, first_grads = [], [], None
    for _ in range(spec["check_steps"]):
        idx, b = next(batches)
        check_trees.append(idx)
        state, metrics = train_step(state, harness.to_device(b, dev), lr,
                                    step_generator())
        checked.append(metrics["loss"])
        if first_grads is None:
            first_grads = {
                names[p]: s["exp_avg"] / (1 - harness.ADAM_B1)
                for p, s in state.optimizer.state.items()}
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(x) for x in checked]
    synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    traced = TracedPart(ctx.recorder(), ctx.trace_seconds, ctx.seconds,
                        program.launches, lambda: synchronize(dev))
    host = HostWatch()
    traced.start()
    host.start()
    t0 = time.perf_counter()
    waits, trees, window_losses, probe = [], [], [], {}
    while True:
        tw = time.perf_counter()
        idx, b = next(batches)
        waits.append(time.perf_counter() - tw)
        b = harness.to_device(b, dev)
        # the window's step ``window_check_step`` is checked too: its
        # state before and after, copied on the device
        probing = len(trees) == spec["window_check_step"]
        if probing:
            probe.update(step=len(trees), before=snapshot(model, state))
        state, metrics = train_step(state, b, lr, step_generator())
        if probing:
            probe["after"] = snapshot(model, state)
        trees.append(idx)
        window_losses.append(metrics["loss"])
        # (a window too short to reach the checked step runs on to it)
        last = time.perf_counter() - t0 >= ctx.seconds and "after" in probe
        traced.done(len(trees), last)
        if last:
            break
    synchronize(dev)
    window_s = time.perf_counter() - t0
    host_readings = host.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    probe["loss"] = float(window_losses[probe["step"]])

    points_per_step = batch * spec["points_per_tree"]
    del state, model, b, metrics, window_losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {
        "setup_s": setup_s,
        "window_s": window_s,
        "attempted": len(trees),
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "host": host_readings,
        "end_to_end": {
            "train_points_per_s": len(trees) * points_per_step / window_s,
        },
    }
    loaded = [np.load(p) for p in paths]
    n_check = spec["check_steps"]
    t_check = time.perf_counter()
    out["readings"] = checks.training(
        ctx, start=start, losses=losses, first_grads=first_grads,
        after=after, clouds=[[loaded[i] for i in idx] for idx in check_trees],
        step_seeds=drawn[:n_check],
        window=window_step(probe, [loaded[i] for i in trees[probe["step"]]],
                           drawn[n_check + probe["step"]]))
    out["checks"] = checks.limited(out["readings"], ctx.config["limits"])
    out["phases"] = {"check_s": time.perf_counter() - t_check}
    if traced.trace is not None:
        h, n = traced.head_steps, traced.steps
        layers = ref.window_layers(loaded, trees[:h + n],
                                   drawn[n_check:n_check + h + n], model_cfg,
                                   dev)
        out["layer_input"] = {
            "kind": "train", "trace": traced.trace,
            "window_s": traced.window_s, "steps": n,
            "launched": traced.launched, "step_layers": layers[h:],
            # the untraced head, for the host-clock readers
            "head_s": traced.head_s, "waits": waits[:h],
            "head_layers": layers[:h],
        }
        out["phases"]["layers_s"] = time.perf_counter() - t_check
    return out


def snapshot(model, state) -> dict:
    """A device copy of the model's state (parameters and buffers, by
    name) and of AdamW's moments (by name; zeros where it holds none) and
    step count."""
    moments = state.optimizer.state
    out = {"model": {n: t.detach().clone()
                     for n, t in model.state_dict().items()},
           "exp_avg": {}, "exp_avg_sq": {}, "steps": 0}
    for n, p in model.named_parameters():
        held = moments.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            out[k][n] = (held[k].clone() if k in held
                         else torch.zeros_like(p.detach()))
        if "step" in held:
            out["steps"] = held["step"].clone()
    return out


def window_step(probe: dict, clouds: list, step_seed: int) -> dict:
    """What :func:`benchmark.lib.checks.training` compares of the window
    step that ``probe`` copied: the state before it, its loss, the
    gradient as AdamW took it (``(exp_avg' - beta1 exp_avg) / (1 -
    beta1)``) and the parameters after it, with its clouds and its
    generator's seed."""
    before, after = probe["before"], probe["after"]
    b1 = program.port("train.harness").ADAM_B1
    return {
        "start": before["model"],
        "moments": (before["exp_avg"], before["exp_avg_sq"],
                    int(float(before["steps"]))),
        "loss": probe["loss"],
        "grads": {n: (m - b1 * before["exp_avg"][n]) / (1 - b1)
                  for n, m in after["exp_avg"].items()},
        "params": {n: after["model"][n] for n in after["exp_avg"]},
        "clouds": clouds, "step_seed": step_seed,
    }


def check_inputs(ctx):
    """What a run hands the reference, made without the program: the
    seed's weights, the clouds of each checked step and the steps'
    generator seeds (as :func:`run` draws them)."""
    spec, seed = ctx.traffic, ctx.seed
    rng = traffic.stream(seed, 1)
    clouds = [traffic.labeled_tree(sk, rng, spec)[0]
              for sk in traffic.skeletons(spec)]
    n, b = len(clouds), spec["batch_size"]
    orders = itertools.chain.from_iterable(
        np.array_split(traffic.epoch_order(seed, e, n), range(b, n, b))
        for e in itertools.count())
    steps = [next(orders) for _ in range(spec["check_steps"])]
    seeds = traffic.stream(seed, 3)
    start = make_state(ctx.reference.state_specs(ctx.config["model"]), seed,
                       ctx.device)
    return (start, [[clouds[i] for i in idx] for idx in steps],
            [int(seeds.integers(2**62)) for _ in steps])
