"""One run of one benchmark cell, driven by the cell's files.

`BENCHMARK.json` (the checkout's root) names the cells and the metrics;
`workloads/<cell>.json` gives a cell's configuration, traffic mix, chips,
the size of its traced window and the limits of its output comparison;
`configs/<config>.json` the configuration; `traffic/<mix>.json` the
traffic's parameters and the driver (`traffic/<driver>.py`) that runs it;
`end_to_end/<metric>.json` how an end-to-end metric is reduced from the
window's units; `metrics/<metric>.py` a per-layer reader of the trace.

A driver's ``setup(run)`` builds the program's objects and warms every
shape the traffic uses; the session it returns runs one timed unit per
``unit(i)`` call (a training chunk, a request) and returns the work it
completed; after the window ``finish()`` keeps what the comparison needs
and frees the program's state, and ``check()`` returns the compared
numbers, each with its limit.
"""
import hashlib
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
#: what no process of the benchmark may load, compared by whole top-level
#: module names (the port's name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dgp_tpu"})


def forbidden_modules():
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def load_json(path):
    return json.loads(Path(path).read_text())


def cell_files(cell, bench=BENCH):
    """The cell's own file, its configuration and its traffic mix, found by
    name under ``bench``."""
    bench = Path(bench)
    spec = load_json(bench / "workloads" / f"{cell}.json")
    config = load_json(bench / "configs" / f"{spec['config']}.json")
    mix = load_json(bench / "traffic" / f"{spec['traffic']}.json")
    return spec, config, mix


def load_module(path, name):
    """The module at ``path`` (names with dots do not import by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed, purpose):
    """A 31-bit seed for one purpose, from the run's seed (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


class Run:
    """What a driver knows of its run."""

    def __init__(self, cell, spec, config, mix, seed, seconds, trace, device, dtype):
        self.cell, self.spec, self.config, self.mix = cell, spec, config, mix
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device, self.dtype = device, dtype

    def seed_for(self, purpose):
        return sub_seed(self.seed, purpose)

    def rng(self, purpose):
        return np.random.RandomState(self.seed_for(purpose))

    def checked_units(self):
        """The units whose outputs the comparison judges, drawn from the
        seed: the first, and ``check_units`` - 1 more among the first
        ``check_from`` (those that the window completes are judged)."""
        k, first = self.spec["check_units"], self.spec["check_from"]
        rest = self.rng("checked_units").choice(np.arange(1, first), size=k - 1,
                                                replace=False)
        return {0, *(int(i) for i in rest)}


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_window(session, seconds, max_units, device):
    """Units back to back until ``seconds`` have passed (or ``max_units``
    have run): one record each, with its start and end in seconds from the
    window's start."""
    records = []
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter() - t0
        try:
            work, ok = session.unit(i), True
        except Exception:     # a failed unit is counted, and fails the run
            log(f"unit {i} failed:\n{traceback.format_exc()}")
            work, ok = {}, False
        _sync(device)
        end = time.perf_counter() - t0
        records.append({"start": start, "end": end, "work": work, "ok": ok})
        i += 1
        if end >= seconds or (max_units and i >= max_units):
            return records


def reduce_end_to_end(spec, records, setup_s):
    kind = spec["reduce"]
    if kind == "setup":
        return setup_s
    done = [r for r in records if r["ok"]]
    if kind == "rate":
        total = sum(r["work"].get(spec["work"], 0) for r in done)
        return total / records[-1]["end"] if total else None
    if kind == "quantile":
        lat = [1e3 * (r["end"] - r["start"]) for r in done]
        if len(lat) < 2:
            return None
        return statistics.quantiles(lat, n=100, method="inclusive")[round(100 * spec["q"]) - 1]
    raise ValueError(f"unknown reduction: {kind}")


def metrics_of(cell, section, root=ROOT):
    """The metrics of BENCHMARK.json's ``section`` that the cell reports."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    if section == "end_to_end":
        return [m for m in bench[section] if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in metrics_of(cell, "end_to_end", root)}
    return [m for m in bench[section]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def nvidia_smi():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc!r}"


def run_cell(cell, seed, seconds, trace, t_start, device="cuda", dtype="float64",
             files=None):
    """One run of ``cell``: set-up, the window, the comparison.  Returns the
    result line's object (``correct`` false where a compared number is over
    its limit).  ``files`` replaces the cell's (spec, config, mix), as the
    tests do to run a cell small on the CPU."""
    import torch
    from . import hooks as hooks_mod
    from . import trace as trace_mod

    spec, config, mix = files or cell_files(cell)
    driver = importlib.import_module(f"benchmark.traffic.{mix['driver']}")
    run = Run(cell, spec, config, mix, seed, seconds, trace, device, dtype)
    t_driver = time.perf_counter()
    session = driver.setup(run)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"{cell}: set-up {setup_s:.3f} s ({t_driver - t_start:.3f} s to the driver's)")

    counter, prof = None, None
    with hooks_mod.Hooks() as hooks:
        if trace:
            counter = trace_mod.Counter()
            counter.install(hooks)
            prof = trace_mod.profiler()
            prof.__enter__()
        try:
            records = run_window(session, seconds, spec["trace_units"] if trace else None,
                                 device)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}")
    on_card = str(device).startswith("cuda")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    work = {}
    for r in records:
        for k, v in r["work"].items():
            work[k] = work.get(k, 0) + v
    window_s = records[-1]["end"]
    log(f"{cell}: window {window_s:.3f} s, {len(records)} units, {work}; unit ends (s): "
        + " ".join(f"{r['end']:.3f}" for r in records))
    session.finish()
    t_check = time.perf_counter()
    checks = session.check()
    log(f"{cell}: comparison {time.perf_counter() - t_check:.3f} s")

    metrics, extra = {}, {}
    if trace:
        t_trace = time.perf_counter()
        tr = trace_mod.Trace(trace_mod.events_of(prof), work, counter, window_s)
        log(f"{cell}: trace read in {time.perf_counter() - t_trace:.3f} s")
        for m in metrics_of(cell, "per_layer"):
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
            value = reader.read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        for m in metrics_of(cell, "end_to_end"):
            how = load_json(BENCH / "end_to_end" / f"{m['name']}.json")
            value = reduce_end_to_end(how, records, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(not r["ok"] for r in records)
    correct = (failed == 0 and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks))
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": spec["chips"] if on_card else 0,
                         "memory_peak_bytes": memory_peak,
                         "nvidia_smi": nvidia_smi() if on_card else "", **extra},
                         "work": work}
    if trace:
        result["breakdown"] = tr.breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}")
    return result


def main(argv, t_start):
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    spec, _, _ = cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        log(f"{args.workload} needs {spec['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, args.trace, t_start)
    except SystemExit as exc:
        log(f"run refused: {exc}")
        return 3
    log(f"device: {result['device']['kind']}; nvidia-smi: {result['device']['nvidia_smi']}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
