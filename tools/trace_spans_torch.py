"""Where dgp_tpu_torch's time goes on the card, by the program's own spans
(`dgp_tpu_torch.tracing`) joined with torch.profiler's device records
(`tracing.idle_by_span`).

    python3 tools/trace_spans_torch.py --workload <cell> [--seed N] [--syncs]

(for example ``--workload dgp3_hetero_n2000.sem``, whose table holds the
likelihood layer's ``sem.exact_draw`` and the ``sem.ess`` spans by route,
or ``--workload dgp3_cat_n5000.sem``, whose table holds the block
``sem.ess`` spans of both layers and the ``sem.lik`` spans of the
Categorical density)

sets up a benchmark cell (`benchmark/workloads/<cell>.json`) as
`benchmark/run.py` does, runs its traced window (the cell's
``trace_units`` units under the benchmark's profiler) and prints one JSON
line: per span name its calls, host ms, own host ms, device busy and idle
ms, kernel-launch calls and copies to the host, each also per unit of the
window's work (SEM iteration or request), and again with the spans that
carry a ``kind`` (`predict.linked_moments`, `predict.container`,
`sem.exact_draw`), a ``route`` (`sem.ess`: block or nodewise), a
``layer`` (`sem.ess`, `sem.exact_draw`, `predict.container`) or a
``name`` (`sem.lik`: the likelihood node's) split by them; the program's
counters over the window (``prior.passes`` and ``prior.columns`` among
them); and the window's kernels,
copies to the host and device synchronisations as the benchmark's `Trace`
counts them.  With ``--syncs``
one more unit then runs under `torch.cuda.set_sync_debug_mode('warn')`,
and every synchronising call is counted by the innermost frame of
`dgp_tpu_torch` on its stack: the program's reads that do not go through
`tracing.to_host` show there.

`window(name, fn)` is the same measurement around any call (the card
synchronised on both sides); `tools/split_cost.py --profile` and
`tools/large_n_torch.py profile` use it.
"""
import argparse
import importlib
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _per(table, units):
    return {name: {**row, "per_unit": {k: v / units for k, v in row.items() if k != "calls"}}
            for name, row in sorted(table.items(), key=lambda kv: -kv[1]["ms"])}


def _split(span):
    """The span under its name with its ``kind``, ``route``, ``layer`` and
    ``name`` attrs appended, those it carries."""
    attrs = [f"{key}={span.attrs[key]}" for key in ("kind", "route", "layer", "name")
             if key in span.attrs]
    return span._replace(name=f"{span.name}[{','.join(attrs)}]") if attrs else span


def window(name, fn):
    """``fn()`` in one profiler window (device activity, as the benchmark's
    traced run records it) with the program recording: wall seconds, the
    device's busy seconds (the union of its intervals) and share, each
    hand-written kernel's launches and device ms, all kernel-launch calls,
    and the spans' table (`tracing.idle_by_span`; None for a tree of the
    program without `tracing`).  Prints and returns it."""
    import torch
    import chip_smoke
    from benchmark.harness import trace as trace_mod
    try:
        from dgp_tpu_torch import tracing
    except ImportError:
        tracing = None
    torch.cuda.synchronize()
    before = chip_smoke.launch_counts()
    prof = trace_mod.profiler()
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = trace_mod.events_of(prof)
    tr = trace_mod.Trace(events, {}, None, wall)
    out = {"window": name, "wall_s": wall, "device_busy_s": tr.busy_s,
           "device_busy_share": tr.busy_s / wall,
           "launches": {k: v - before[k] for k, v in chip_smoke.launch_counts().items()},
           "kernel_device_ms": {k: 1e3 * tr.kernel_seconds(sym)
                                for k, sym in chip_smoke.KERNEL_SYMBOLS.items()},
           "cuda_launch_kernel_calls": sum(1 for n, on_device, _, _ in events
                                           if not on_device and n.startswith("cudaLaunchKernel")),
           "spans": tracing and tracing.idle_by_span(events)}
    print(json.dumps(out), flush=True)
    return out


def _syncs(fn):
    """Synchronising calls made by ``fn()``, by the innermost frame of
    dgp_tpu_torch on the stack (file:line function)."""
    import torch
    found = {}

    def note(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if "dgp_tpu_torch" in f.filename]
        key = (f"{Path(frames[-1].filename).name}:{frames[-1].lineno} {frames[-1].name}"
               if frames else "outside dgp_tpu_torch")
        found[key] = found.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old = warnings.showwarning
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    return dict(sorted(found.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--syncs", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    from benchmark.harness import core
    from benchmark.harness import trace as trace_mod
    from dgp_tpu_torch import tracing
    spec, config, mix = core.cell_files(args.workload)
    driver = importlib.import_module(f"benchmark.traffic.{mix['driver']}")
    run = core.Run(args.workload, spec, config, mix, args.seed, 0.0, True, "cuda", "float64")
    session = driver.setup(run)
    torch.cuda.synchronize()
    prof = trace_mod.profiler()
    with prof:
        records = core.run_window(session, float("inf"), spec["trace_units"], "cuda")
    rec = tracing.last()
    events = trace_mod.events_of(prof)
    work = {}
    for r in records:
        for k, v in r["work"].items():
            work[k] = work.get(k, 0) + v
    units = work.get("iterations") or work.get("requests")
    tr = trace_mod.Trace(events, work, None, records[-1]["end"])
    out = {"workload": args.workload, "seed": args.seed, "card": core.nvidia_smi(),
           "torch": torch.__version__, "work": work, "window_s": tr.window_s,
           "busy_s": tr.busy_s, "trace_kernels": tr.n_kernels, "trace_dtoh": tr.n_dtoh,
           "trace_device_syncs": tr.n_device_syncs, "counters": rec.counters,
           "roots": sorted({s.name for s in rec.spans if s.parent is None}),
           "spans": _per(tracing.idle_by_span(events, rec.spans), units),
           "spans_by_kind": _per(tracing.idle_by_span(events, [
               _split(s) for s in rec.spans]), units)}
    if args.syncs:
        n = len(records)
        out["syncs_one_unit"] = _syncs(lambda: session.unit(n))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
