"""Device-mesh helpers; the counterpart of `dgp_tpu/parallel/mesh.py`.

The reference's only parallelism is chunking over process pools
(gp.ppredict, emulator.ppredict, lgp.ppredict, dgp.ptrain).  The JAX
package shards the test rows and the SEM state over a 1-D device mesh and
lets GSPMD partition the programs.  Here a mesh is a tuple of torch
devices: a model on the CPU gets a one-device CPU mesh, a model on the
card every visible CUDA device, its own first.

A split cuts a point axis into shares, contiguous ranges that differ in
size by at most one row, one per mesh entry (`shard_rows`; fewer where the
axis has fewer points than the mesh has entries).  A prediction's shares
are made of whole chunks of its query rows instead, the chunks of the
one-device call: on the card a library's batched factorisation or product
may take another algorithm at another batch size, so a query's result is
the one-device result only in the same chunk.  Every per-point
computation of a share runs on its entry's device, launched from the one
host thread onto that device's current stream; its outputs are copied
device to device onto the model's device (the mesh's first entry) and
joined there in share order, so a reduction over them is the one-device
reduction of the same values.  Every share but the first computes on
copies (`move`), also where its entry is the model's own device, as on a
mesh of two shares of one card; the first share computes on the model's
tensors, so a one-entry mesh is the one-device computation with no copy.

`dgp.train` runs SEM's per-point kernel calls through a `Split`
(`shard_latent_state`: the latents are copied to the other entries after
each change, never the gathered blocks), and the ensemble prediction of
`emulator.predict` its query rows; the host-driven predictions of
`gp.ppredict` and `lgp.ppredict` run each share's rows through the same
code on one host thread per share (`map_shares`).
"""
import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import tracing


def device_mesh():
    """Every visible CUDA device; raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for a device mesh; "
                           "a model built with device='cpu' gets a one-device "
                           "CPU mesh")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def model_mesh(device):
    """The mesh of a model that computes on ``device``: the CPU alone, or
    every visible card with ``device`` first.  A CUDA device without an
    index (``'cuda'``) is the current card, so it appears once."""
    device = torch.device(device)
    if device.type == "cpu":
        return (device,)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return (device,) + tuple(d for d in device_mesh() if d != device)


def shard_rows(n, mesh, chunk=1):
    """The shares of a point axis of n entries over ``mesh``: (device,
    slice) pairs in order, contiguous, covering 0..n once, each made of
    whole chunks of ``chunk`` entries (the last chunk may be short), their
    numbers of chunks differing by at most one, one share per entry while
    the chunks allow (at least one share)."""
    c = -(-n // chunk)
    k = max(1, min(c, len(mesh)))
    base, extra = divmod(c, k)
    out, start = [], 0
    for i in range(k):
        stop = start + base + (i < extra)
        out.append((torch.device(mesh[i]), slice(min(start * chunk, n), min(stop * chunk, n))))
        start = stop
    return tuple(out)


def chunks(sl, size):
    """The consecutive slices of at most ``size`` entries that cover the
    slice ``sl``."""
    return [slice(s, min(s + size, sl.stop)) for s in range(sl.start, sl.stop, size)]


def row_chunks(n, chunk=None):
    """Consecutive slices of at most ``chunk`` rows (default: all) that
    cover 0..n, at least one."""
    step = chunk or max(n, 1)
    return [slice(s, min(s + step, n)) for s in range(0, max(n, 1), step)]


def on_device(device):
    """Make ``device`` current for the launches inside (a no-op on the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def move(t, device):
    """A copy of ``t`` on ``device`` (a copy also on ``t``'s own device)."""
    return t.to(device, non_blocking=True, copy=True)


def shard_latent_state(state, mesh):
    """The SEM state (latents, params) on the mesh: one state per entry,
    the first the state itself (on the model's device), each other a copy
    of its latents and parameters on its device (n x width values per
    latent layer).  On a one-entry mesh, the state itself."""
    if len(mesh) == 1:
        return state
    latents, params = state
    out = [state]
    for dev in mesh[1:]:
        dev = torch.device(dev)
        out.append((tuple(move(a, dev) for a in latents),
                    tuple(tuple(None if p is None else
                                {k: move(v, dev) for k, v in p.items()}
                                for p in layer) for layer in params)))
    return tuple(out)


class Split:
    """A point axis of n entries split over a mesh: one share over all of
    it on a one-entry mesh, where every method below is the identity."""

    def __init__(self, mesh, n, chunk=1):
        self.home = torch.device(mesh[0])
        self.shares = shard_rows(n, mesh, chunk)
        self.devices = tuple(dev for dev, _ in self.shares)
        self.n = n

    def __len__(self):
        return len(self.shares)

    def copies(self, t):
        """``t`` whole for every share: itself for the first, a copy on
        its device for each other."""
        return [t] + [move(t, dev) for dev in self.devices[1:]]

    def cols(self, t, dim=-1):
        """Each share's range of ``t`` along ``dim``, contiguous, on its
        device."""
        out = []
        for i, (dev, sl) in enumerate(self.shares):
            part = t.narrow(dim, sl.start, sl.stop - sl.start)
            out.append((part if i == 0 else move(part, dev)).contiguous())
        return out

    def gather(self, parts, dim=-1):
        """The shares' outputs joined on the model's device in share order."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([parts[0]] + [move(p, self.home) for p in parts[1:]], dim=dim)

    def run(self, fn, *per_share):
        """[fn(device, slice, *args_i)] over the shares, each on its
        device; ``per_share`` are lists with one entry per share."""
        out = []
        for i, (dev, sl) in enumerate(self.shares):
            with on_device(dev):
                out.append(fn(dev, sl, *(a[i] for a in per_share)))
        return out

    def gathered(self, fn, *per_share, dim=-1):
        """`run` of ``fn`` returning a tuple of tensors per share, each
        joined along ``dim`` by `gather`."""
        parts = self.run(fn, *per_share)
        return tuple(self.gather(list(p), dim=dim) for p in zip(*parts))


def map_shares(mesh, n, fn, chunk=1):
    """[fn(device, slice)] over the shares of n rows (of whole chunks of
    ``chunk`` rows), each called on its own host thread with its device
    current, in share order: host-driven code whose calls read back from
    the device overlaps across cards.  Each thread's spans nest under the
    caller's open span (`tracing.carry`)."""
    shares = shard_rows(n, mesh, chunk)

    def call(share):
        dev, sl = share
        with on_device(dev):
            return fn(dev, sl)

    if len(shares) == 1:
        return [call(shares[0])]
    with ThreadPoolExecutor(max_workers=len(shares)) as pool:
        return list(pool.map(tracing.carry(call), shares))
