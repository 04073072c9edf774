"""Spans and counters of the program: where its host time goes, on the
clock of torch.profiler's records.

* ``span(name, **attrs)`` is a context manager that records the name,
  start and end (ns since the epoch, `time.time_ns`: the clock of
  Kineto's records, so a span lines up with the profiler's host and
  device events), the enclosing span and the root's id.  The spans of one
  root (one `dgp.train` call, one `lgp.predict` request) share its id.
  The stack of open spans is per host thread; `carry` hands a thread's
  open span to the work it gives another thread.
* ``count(name, k=1)`` adds to always-on totals (`totals`, `reset`) and
  to the recording that is on.
* ``to_host(t, cause)`` and ``host_read(cause)`` mark a read from the
  device, the copy the caller makes: a ``host_read`` span (the host's
  wait) and the counter ``host_reads.<cause>``.

A recording is on while a torch profiler is active -- it begins at the
first instrumented call after the profiler turns on and closes at the
first after it turns off -- or inside ``with recording():``.  `last`
returns the newest: its spans, complete, and the counts made while it was
on.  Otherwise `span` returns one shared no-op object after a flag read.

`idle_by_span` joins a recording's spans with a profiler's events
(``(name, on_device, start_us, end_us)`` tuples): per span name, the
host's own time, the device's busy and idle time inside the spans, the
kernel launches they made and their copies to the host.

Names: SEM's ``sem.train`` (root), ``sem.chunk``, ``sem.istep``,
``sem.prior_draw``, ``sem.ess`` (one transition; attrs ``layer`` and
``route``, block or nodewise, and for a block ``cols``, the latent columns
it moves), ``sem.ess.round`` (one batch of candidates and its read),
``sem.exact_draw`` (attrs ``layer`` and ``kind``, vecchia or dense),
``sem.lik`` (a likelihood node's log-likelihood; attrs ``name`` and
``candidates``), ``sem.mstep``, ``lbfgs.eval``, ``nn.refresh``,
``nn.ivf_build``, ``nn.ivf_query``;
prediction's ``lgp.predict`` and ``emulator.predict`` (roots),
``predict.imputation``, ``predict.container`` (attrs ``kind``,
``layer``), ``predict.nn_search``, ``predict.kriging``,
``predict.linked_moments`` (attr ``kind``: dense or vecchia); and
``host_read`` (attr ``cause``).  Counters: ``ess.rounds``,
``ess.candidates``, ``ess.transitions``, ``ess.moves``, ``lbfgs.evals``,
``exact_draws.<vecchia|dense>``, ``lik.evals``, ``lik.candidates``,
``prior.passes`` (ancestral passes of Vecchia prior draws),
``prior.columns`` (node columns the prior draws gave),
``host_reads.<cause>``, ``kernel.launches.<K1-K5>`` (and
``...@<device>``), ``kernel.plain_calls.<K1-K4>``; a prediction's
training-side device operands (`kernel._op`): ``pred_ops.made``,
``pred_ops.kept`` (reused from an earlier call), ``pred_ops.upload_bytes``
(the bytes of those made on a CUDA device).
"""
import bisect
import itertools
import threading
import time
from collections import namedtuple
from contextlib import contextmanager

import torch

_prof = torch.autograd.profiler

#: one finished span: ids, name, times (ns since the epoch), attrs, and the
#: host thread it ran on
Span = namedtuple("Span", "id parent root name start_ns end_ns attrs thread")


class Recording:
    """The spans (`Span`, in the order they ended) and the counts of one
    recording window, and its end (ns since the epoch; None while on)."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.end_ns = None


_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_totals = {}
_forced = None      # the recording of an active `recording()` block
_open = None        # the recording of an active profiler
_last = None


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _on():
    """The recording that is on, or None; opens one for a profiler that
    turned on and closes it once the profiler is off."""
    global _open, _last
    if _forced is not None:
        return _forced
    if _prof._is_profiler_enabled:
        if _open is None:
            with _lock:
                if _open is None:
                    _open = _last = Recording()
        return _open
    if _open is not None:
        with _lock:
            if _open is not None:
                _open.end_ns = time.time_ns()
                _open = None
    return None


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "root", "start")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        st = _stack()
        self.id = next(_ids)
        if st:
            self.parent, self.root = st[-1].id, st[-1].root
        else:
            self.parent, self.root = None, self.id
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        self.rec.spans.append(Span(self.id, self.parent, self.root, self.name, self.start,
                                   end, self.attrs, threading.get_ident()))
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


def span(name, /, **attrs):
    """A span of ``name`` around the ``with`` block, recorded while a
    recording is on (a shared no-op otherwise)."""
    if _forced is None and not _prof._is_profiler_enabled:
        if _open is not None:
            _on()
        return _NOOP
    return _Span(_on(), name, attrs)


def count(name, k=1):
    """Add ``k`` to the counter ``name``: to its total and, while one is on,
    to the recording's."""
    rec = _on()
    with _lock:
        _totals[name] = _totals.get(name, 0) + k
        if rec is not None:
            rec.counters[name] = rec.counters.get(name, 0) + k


def host_read(cause):
    """A ``host_read`` span around a read from the device that the caller
    makes (an implicit one, as ``torch.nonzero``'s), counted under
    ``host_reads.<cause>``."""
    count("host_reads." + cause)
    return span("host_read", cause=cause)


def to_host(t, cause):
    """``t.cpu()``, the one copy the caller reads, as a `host_read`."""
    with host_read(cause):
        return t.cpu()


def carry(fn):
    """``fn`` to run on another host thread under this thread's open span
    (itself where none is open)."""
    st = _stack()
    if not st:
        return fn
    top = st[-1]

    def call(*args, **kwargs):
        mine = _stack()
        mine.append(top)
        try:
            return fn(*args, **kwargs)
        finally:
            mine.pop()
    return call


@contextmanager
def recording():
    """Record every span and count made inside, in every thread; yields
    the `Recording`."""
    global _forced, _last
    rec, prev = Recording(), _forced
    _forced = _last = rec
    try:
        yield rec
    finally:
        rec.end_ns = time.time_ns()
        _forced = prev


def last():
    """The newest recording (still filling while it is on), or None."""
    _on()
    return _last


def totals(prefix=""):
    """The always-on counters whose names start with ``prefix``."""
    with _lock:
        return {k: v for k, v in _totals.items() if k.startswith(prefix)}


def reset(prefix=""):
    """Zero the always-on counters whose names start with ``prefix``."""
    with _lock:
        for k in [k for k in _totals if k.startswith(prefix)]:
            del _totals[k]


_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(events, spans=None):
    """Per span name, over the spans of a recording (by default `last`'s)
    and a profiler's events, ``(name, on_device, start_us, end_us)`` tuples
    on the same clock: ``calls``; ``ms``, their host time; ``self_ms``, less
    the time of their child spans; ``busy_ms``, the union of the device's
    kernel, copy and set intervals inside them, and ``idle_ms``, the rest
    of their time; ``launches``, the kernel-launch calls of the CUDA
    runtime they made; ``dtoh``, the device's copies to the host that
    began inside them.  A span's figures include its children's.

    From a profiler ``prof`` over instrumented calls::

        from torch.autograd import DeviceType
        events = [(e.name(), e.device_type() == DeviceType.CUDA,
                   e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                  for e in prof.profiler.kineto_results.events()]
        table = tracing.idle_by_span(events)
    """
    if spans is None:
        rec = last()
        spans = rec.spans if rec is not None else []
    merged = _union([(a, b) for _, on_device, a, b in events if on_device])
    starts = [a for a, _ in merged]
    cum = [0.0]
    for a, b in merged:
        cum.append(cum[-1] + b - a)
    launches = sorted(a for n, on_device, a, _ in events
                      if not on_device and n.startswith(_LAUNCHES))
    dtoh = sorted(a for n, on_device, a, _ in events
                  if on_device and n.startswith("Memcpy DtoH"))

    def busy(a, b):
        lo = max(bisect.bisect_right(starts, a) - 1, 0)
        hi = bisect.bisect_left(starts, b)
        if lo >= hi:
            return 0.0
        s0, e0 = merged[lo]
        s1, e1 = merged[hi - 1]
        return (cum[hi] - cum[lo] - max(0.0, min(a, e0) - s0)
                - max(0.0, e1 - max(b, s1)))

    def within(sorted_starts, a, b):
        return bisect.bisect_right(sorted_starts, b) - bisect.bisect_left(sorted_starts, a)

    children = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    out = {}
    for s in spans:
        a, b = s.start_ns / 1e3, s.end_ns / 1e3
        row = out.setdefault(s.name, dict(calls=0, ms=0.0, self_ms=0.0, busy_ms=0.0,
                                          idle_ms=0.0, launches=0, dtoh=0))
        dev = busy(a, b)
        row["calls"] += 1
        row["ms"] += (b - a) / 1e3
        row["self_ms"] += (s.end_ns - s.start_ns - children.get(s.id, 0)) / 1e6
        row["busy_ms"] += dev / 1e3
        row["idle_ms"] += (b - a - dev) / 1e3
        row["launches"] += within(launches, a, b)
        row["dtoh"] += within(dtoh, a, b)
    return out
