"""The benchmark's general part: it finds a cell's configuration, traffic,
limits and per-layer readers by the names in BENCHMARK.json, runs the
traffic's driver once, checks the outputs against the plain reference, and
prints the result line.

    python3 portbench/run.py --workload fp32-archive --seed 7 --seconds 40 --trace 0

Files, found by name (a new cell, mix, configuration or metric is a new
file and a new entry, never an edit):

- BENCHMARK.json's configuration entry names its file (portbench/configs/);
- portbench/traffic/<traffic>.json holds a mix's parameters; its "driver"
  names the module portbench/drivers/<driver>.py that runs that kind of
  traffic (`run(cell) -> Outcome`);
- portbench/limits/<cell>.json holds each compared number's limit and the
  readings it was set from;
- portbench/metrics/<metric>.py reads one per-layer metric from a traced
  run (`read(ctx) -> float | None`; None leaves it out of the line).

A quantity split by cells, so that each part moves its own end-to-end
metric or keeps its own bound, is named `<quantity>.<part>`: with no file
or reading of that name, the reader of `<quantity>` (portbench/metrics/
<quantity>.py) or the driver's reading `<quantity>` stands for it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that no run may load (the JAX package and JAX).
FORBIDDEN = ("jax", "jaxlib", "flax", "echoflow")


@dataclass
class Cell:
    """One run of one cell: what a driver is given."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    control: str = ""       # the reference in the program's place (see parse_args)
    t0: float = 0.0          # the process's start, on time.perf_counter's clock


@dataclass
class Outcome:
    """What a driver returns. `metrics` are the end-to-end readings by name;
    `checks` each compared number, {name: value}; `context` what the
    per-layer readers read (the trace, the units of work in it)."""

    attempted: int
    failed: int
    metrics: dict
    checks: dict
    memory_peak_bytes: int = 0
    context: dict = field(default_factory=dict)
    trace: object = None


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT):
    """(benchmark, workload entry, config, traffic, limits) of a cell of the
    checkout at `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"portbench: no workload named {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{work['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{name}.json").read_text())
    return bench, work, config, traffic, limits


def metrics_of(bench, work, kind: str) -> list:
    """The metric entries of `kind` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, or list nothing and move an end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or work["name"] in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if work["name"] in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def split_names(name: str):
    """`name`, then the names of the quantity it parts (`a.b.c`: `a.b`, `a`)."""
    parts = name.split(".")
    return [".".join(parts[:n]) for n in range(len(parts), 0, -1)]


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of per-layer metric `name`: its own file, or that of the
    quantity it parts."""
    metrics = root / "portbench" / "metrics"
    return next((metrics / f"{n}.py" for n in split_names(name)
                 if (metrics / f"{n}.py").is_file()), metrics / f"{name}.py")


def reading(readings: dict, name: str):
    """The driver's reading of end-to-end metric `name`, or of the quantity
    it parts; None if it has neither."""
    return next((readings[n] for n in split_names(name) if n in readings), None)


def per_layer(bench, work, outcome, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of the per-layer readers that found
    something to read."""
    out = {}
    for i, m in enumerate(metrics_of(bench, work, "per_layer")):
        reader = load_module(reader_path(m["name"], root), f"portbench_metric_{i}")
        value = reader.read(outcome.context)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def print_setup(t0, marks):
    """The set-up's seconds by phase, on standard error."""
    parts, last = [], t0
    for name, at in marks:
        parts.append(f"{name} {at - last:.2f}")
        last = at
    print("set-up s: " + ", ".join(parts), file=sys.stderr)


def judge(outcome: Outcome, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number that the cell's
    limits name at or under its limit, and no unit of work failed."""
    checks = {name: {"value": outcome.checks[name], "limit": limit}
              for name, limit in limits["limits"].items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok and outcome.failed == 0 and bool(checks), checks


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(bench, work, outcome: Outcome, limits: dict, traced: bool, device: dict,
                root: Path = ROOT):
    """The result's dict, its keys in the order the line prints them."""
    correct, checks = judge(outcome, limits)
    if traced:
        metrics = per_layer(bench, work, outcome, root)
    else:
        metrics = {}
        for m in metrics_of(bench, work, "end_to_end"):
            value = reading(outcome.metrics, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if traced and outcome.trace is not None:
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line["checks"] = checks
    return line


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("", "precision", "half_batch"), default="",
                    help="run the reference in the program's place, in the configuration's "
                         "lower precision or (train traffic) with the loss over half of each "
                         "batch: the readings the limits are set against, not a benchmark run")
    return ap.parse_args(argv)


def run(argv, t0: float, device: str = "cuda", overrides=None, root: Path = ROOT) -> int:
    """One run of a cell; prints the result line and returns the exit code.
    `device` and `overrides` ({"config": {...}, "traffic": {...}}, merged
    into the files' parameters) serve the CPU tests; a benchmark run takes
    neither."""
    args = parse_args(argv)
    bench, work, config, traffic, limits = load_cell(args.workload, root)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < work["chips"]):
        print(f"portbench: the cell needs {work['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    cell = Cell(work["name"], config, traffic, limits, args.seed, args.seconds,
                bool(args.trace), device, args.control, t0)
    driver = load_module(root / "portbench" / "drivers" / f"{traffic['driver']}.py",
                         f"portbench_driver_{traffic['driver']}")
    outcome = driver.run(cell)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": work["chips"], "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if args.trace and outcome.trace is not None:
        dev["busy_s"] = outcome.trace.busy_s()
        dev["window_s"] = outcome.trace.window_s()
    if device == "cuda":
        dev["power"] = power_limit()
    line = result_line(bench, work, outcome, limits, bool(args.trace), dev, root)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, value in outcome.checks.items():
        if name not in line["checks"]:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {float(c['value'])!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
