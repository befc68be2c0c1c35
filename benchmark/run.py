"""One run of one benchmark cell of ``treemorph_tpu_torch`` on the CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic mix and per-layer metrics are found by
their names in ``BENCHMARK.json``: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (its ``kind`` names the loop,
``benchmark/lib/<kind>_loop.py``) and ``benchmark/metrics/<metric>.py``
(each a ``read(window, ctx)`` that returns a number, or ``None`` where it
finds nothing to read). With ``--trace 0`` the run reports the cell's
end-to-end metrics; with ``--trace 1`` the window's last
``TRACE_SECONDS`` run under the profiler and the run reports the
per-layer metrics: those of the device from that traced tail, those of
the host's clock from the untraced head before it. Either way it checks what the
window's path produced against the plain reference, prints each compared
number beside its limit as its last lines on standard error, and prints
one JSON result as the last line of standard output. Without a CUDA card,
or with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "treemorph_tpu")
#: seconds at the end of a ``--trace 1`` window that run under the
#: profiler (its records of a whole window take minutes to collect)
TRACE_SECONDS = 20.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def reported(metrics: list, cell: str) -> list:
    """The metrics of ``metrics`` that ``cell`` reports."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{len(name)}_{abs(hash(name))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def make_context(args, manifest: dict, cell: dict):
    import torch

    from benchmark.lib.trace import Recorder

    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    return SimpleNamespace(
        cell=cell, config=config, traffic=traffic, seed=args.seed,
        device=torch.device("cuda", 0),
        seconds=args.seconds, t_start=T_START, trace_seconds=TRACE_SECONDS,
        reference=importlib.import_module(
            f"benchmark.reference.{config['reference']}"),
        recorder=(lambda: Recorder()) if args.trace else (lambda: None),
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cell_of(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    ctx = make_context(args, manifest, cell)
    loop = importlib.import_module(f"benchmark.lib.{ctx.traffic['kind']}_loop")
    out = loop.run(ctx)

    t_read = time.perf_counter()
    if args.trace:
        window = out["layer_input"]
        metrics = {}
        for m in reported(manifest["per_layer"], cell["name"]):
            value = load_reader(m["name"])(window, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in reported(manifest["end_to_end"], cell["name"])}
    device = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"],
        "power_limit": power_limit(),
    }
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        trace = out["layer_input"]["trace"]
        device["busy_s"] = trace.busy_s()
        device["window_s"] = out["layer_input"]["window_s"]
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    out.setdefault("phases", {})["read_s"] = time.perf_counter() - t_read

    phases = dict(out.get("phases", {}),
                  run_s=time.perf_counter() - T_START)
    # numbers read beside the compared ones; one not finite prints as null
    readings = {k: v if math.isfinite(v) else None
                for k, v in out.get("readings", {}).items()}
    result["diagnostics"] = {"phases": phases,
                             "kept_share": out.get("kept_share"),
                             "host": out.get("host"),
                             "readings": readings}
    print("phases: " + json.dumps(phases), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found), file=sys.stderr)
        return 3
    from benchmark.lib.checks import passed

    checks = out["checks"]
    result["correct"] = out["failed"] == 0 and passed(checks)
    # a number not finite (a shape that differs) prints as null
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # a failed run prints its traceback and no result
        traceback.print_exc()
        sys.exit(1)
