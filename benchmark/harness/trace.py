"""The traced run's instruments: torch.profiler over the window, the count
hooks on the program's entry points (`counts/entry_points.json`), and the
reduction of the trace to what the per-layer readers take (`Trace`).

The profiler records the device's activity alone (kernels, copies, sets,
and the CUDA runtime calls that launch them), not every host operation:
recording SEM's ~7800 launches an iteration as host operations as well
slows its window by about 40%.  It runs over exactly the window, so every
device record lies in it, and the window's length is the host's.
"""
import json
from pathlib import Path

from ..counts import ops as counts

BENCH = Path(__file__).resolve().parent.parent


def load_json(*parts):
    return json.loads(BENCH.joinpath(*parts).read_text())


class Counter:
    """Hooks that count each outermost call of every entry point from its
    arguments' shapes: (operations, bytes) by entry id."""

    def __init__(self):
        self.entries = {e["id"]: e for e in load_json("counts", "entry_points.json")["entries"]}
        self.calls = {k: [] for k in self.entries}

    def _hook(self, entry):
        count = getattr(counts, entry["count"])
        calls = self.calls[entry["id"]]
        depth = [0]

        def hook(original, *args, **kwargs):
            if depth[0] == 0:
                calls.append(count(args, kwargs))
            depth[0] += 1
            try:
                return original(*args, **kwargs)
            finally:
                depth[0] -= 1
        return hook

    def install(self, hooks):
        for entry in self.entries.values():
            hooks.add(entry["module"], entry["attr"], self._hook(entry))


def profiler():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CUDA])


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def events_of(prof):
    """(name, on_device, start_us, end_us) of every event of the profiler's
    trace, from its raw Kineto records."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns() / 1e3))
    return out


class Trace:
    """What the per-layer readers read: the window's length (``window_s``,
    by the host's clock) and the seconds the device was busy in it (the
    union of its kernel, copy and set intervals), device operations by
    name, copies to the host, whole-device synchronisations, the work the
    window completed, and the counted calls of each entry point.
    ``events``: (name, on_device, start_us, end_us) tuples of the window,
    `events_of` a profiler's; the host's are the CUDA runtime's calls."""

    def __init__(self, events, work, counter, window_s):
        device = [(n, a, b) for n, on_device, a, b in events if on_device]
        cpu = [(n, a, b) for n, on_device, a, b in events if not on_device]
        if not device:
            raise RuntimeError("the trace holds no device operation in the window")
        merged = _union([(a, b) for _, a, b in device])
        self.window_s = window_s
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.ops_by_name = {}
        for name, a, b in device:
            c, s = self.ops_by_name.get(name, (0, 0.0))
            self.ops_by_name[name] = (c + 1, s + (b - a) / 1e6)
        self.n_kernels = sum(c for name, (c, _) in self.ops_by_name.items()
                             if not name.startswith(("Memcpy", "Memset")))
        self.n_dtoh = sum(c for name, (c, _) in self.ops_by_name.items()
                          if name.startswith("Memcpy DtoH"))
        self.n_device_syncs = sum(1 for name, _, _ in cpu if name == "cudaDeviceSynchronize")
        self.work = work
        self.counter = counter
        self.peaks = load_json("counts", "peaks.json")
        gaps = sorted(((b2 - a2, a2, b2) for (_, a2), (b2, _) in zip(merged, merged[1:])),
                      reverse=True)[:10]
        self.breakdown = {
            "device_ops": [[name[:120], s] for name, (_, s) in
                           sorted(self.ops_by_name.items(), key=lambda kv: -kv[1][1])[:10]],
            "idle_gaps": [[self._host_at(cpu, (a + b) / 2), d / 1e6] for d, a, b in gaps],
        }

    @staticmethod
    def _host_at(cpu, t):
        """The CUDA runtime call the host was in at time t."""
        best = None
        for name, a, b in cpu:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return "host: " + (best[0][:100] if best else "outside the CUDA runtime")

    def kernel_seconds(self, symbol):
        return sum(s for name, (_, s) in self.ops_by_name.items() if symbol in name)

    def roofline_pct(self, entry_id):
        """The entry's least time over its kernel's device time, or None
        where the window made no such call."""
        entry = self.counter.entries[entry_id]
        calls = self.counter.calls[entry_id]
        t = self.kernel_seconds(entry["kernel"])
        if not calls or t <= 0:
            return None
        least = sum(counts.least_seconds(o, b, self.peaks) for o, b in calls)
        return 100.0 * least / t

    def mfu_pct(self, group, work_key):
        """Counted operations of the group's entries over the window, as a
        share of the float64 tensor-core peak; None where the window did no
        work of ``work_key``, and an error where it did some and counted no
        operations."""
        if not self.work.get(work_key):
            return None
        total = sum(o for eid, e in self.counter.entries.items() if e["group"] == group
                    for o, _ in self.counter.calls[eid])
        if total <= 0:
            raise RuntimeError(f"the window did {work_key} but counted no {group} operations")
        return 100.0 * total / self.window_s / self.peaks["fp64_tensor_flops"]
