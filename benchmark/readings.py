"""The readings a cell's limits are set from, many seeds in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \\
        [--program] [--control]

``--program``: a run of the cell with a one-step window per seed (or
``--seconds``), its compared numbers (the sound program's readings).
``--control``: the configuration's control (the reference one precision
lower) against the reference, on the same inputs. ``--faults`` (training
cells): the reference with half of each batch left out (the mean taken
over the rest) against the whole reference; a step that returns its
state unchanged reads 1 on ``grad`` and ``update`` by their definition.
Prints one JSON line per seed and kind. Needs the CUDA card, as a run
does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loop(ctx):
    import importlib

    return importlib.import_module(
        f"benchmark.lib.{ctx.traffic['kind']}_loop")


def limits_of(ctx) -> dict:
    """The limits of the cell's compared numbers."""
    if ctx.traffic["kind"] == "train":
        return ctx.config["limits"]
    return ctx.config["serve"]["limits"]


def control_checks(ctx) -> dict:
    """The control's readings of one seed: a training cell's on its
    checked steps' inputs, a serving cell's on the requests drawn for the
    check."""
    from benchmark.lib import checks, serve_loop, train_loop, traffic

    if ctx.traffic["kind"] == "train":
        start, clouds, step_seeds = train_loop.check_inputs(ctx)
        return checks.control_training(ctx, start, clouds, step_seeds)
    spec = ctx.traffic
    pool = traffic.serving_pool(spec, ctx.seed)
    weights = serve_loop.weights_of(ctx, ctx.device, pool)
    sample = serve_loop.check_sample(spec, ctx.seed, pool)
    requests = traffic.stream(ctx.seed, 7)
    clouds = [traffic.request(pool, i, requests)
              for i in range(max(sample) + 1)]
    return checks.control_serving(ctx, weights,
                                  {i: clouds[i] for i in sorted(sample)})


def half_batch_checks(ctx) -> dict:
    """A training cell's readings with half of each checked batch left
    out, the reference in the program's place."""
    from benchmark.lib import checks, train_loop
    from benchmark.reference import train as ref_train

    start, clouds, step_seeds = train_loop.check_inputs(ctx)
    whole = checks.reference_steps(ctx, start, clouds, step_seeds)
    half = checks.reference_steps(ctx, start,
                                  [c[:len(c) // 2] for c in clouds],
                                  step_seeds)
    return ref_train.gaps(half, whole, start)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="the --program runs' window (a serving cell's "
                        "must reach the requests drawn for its check)")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import run

    manifest = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = run.cell_of(manifest, args.workload)
    from benchmark.lib.checks import limited

    def show(seed, kind, readings, **extra):
        print(json.dumps({"seed": seed, "kind": kind,
                          "checks": limited(readings, limits_of(ctx)),
                          "readings": readings, **extra}), flush=True)

    for seed in args.seeds:
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        if args.program:
            ctx = run.make_context(ns, manifest, cell)
            ctx.t_start = time.perf_counter()
            out = loop(ctx).run(ctx)
            show(seed, "program", out.get("readings", {
                k: v for k, (v, _) in out["checks"].items()}),
                setup_s=out["setup_s"])
        if args.control:
            ctx = run.make_context(ns, manifest, cell)
            show(seed, "control", control_checks(ctx))
        if args.faults:
            ctx = run.make_context(ns, manifest, cell)
            show(seed, "half the batch", half_batch_checks(ctx))


if __name__ == "__main__":
    main()
