"""Prediction requests to a DGP emulator: one closed-loop client sends
`emulator.predict(x, m=pred_m)` requests back to back.

Mix parameters: ``warm_iterations`` and ``chunk`` (the SEM training that
set-up runs before it builds the emulator of the configuration's
``emulator_N`` imputations), ``sizes_min``, ``sizes_max`` and
``sizes_count`` (every seed sends the same ``sizes_count`` request sizes,
log-uniform between the two, in its own order, and then again), and the
query points, uniform on the data's domain.

The comparison follows the program's own state (the trained emulator's
imputations and hyper-parameters, and the neighbour sets its IVF search
found for each judged request) and works every judged request's
prediction out again in float64:

  * ``predict_gap``: over the judged requests' points, the larger of
    |mean - ref mean| / ref sd and |var - ref var| / ref var;
  * ``nn_miss``: one less the recall of each IVF search -- layer 0's, and
    layer 1's of each imputation -- over every query of the judged
    requests, against the exact search (the recall the repository gates
    its IVF search on: hits over all queries of a search); the worst
    search's.
"""
import gc

import numpy as np
import torch

from ..harness import data, models
from ..harness.core import log
from ..harness.hooks import Hooks
from ..reference import predict as ref


def request_sizes(run):
    mix = run.mix
    sizes = np.exp(np.linspace(np.log(mix["sizes_min"]), np.log(mix["sizes_max"]),
                               mix["sizes_count"])).round().astype(int)
    return sizes[run.rng("sizes").permutation(len(sizes))]


def setup(run):
    import dgp_tpu_torch as dt
    dt.set_default_dtype(run.dtype)
    cfg = run.config
    X, Y = data.design(run.rng("data"), cfg["data"])
    model = models.sem_dgp(dt, run, X, Y)
    dt.nb_seed(run.seed_for("emulator"))
    emu = dt.emulator(model.estimate(), N=cfg["emulator_N"], device=run.device)
    del model
    s = Session(run, emu, X, Y)
    # every shape the traffic sends: the largest request and the smallest
    for size in (run.mix["sizes_max"], run.mix["sizes_min"]):
        s.emu.predict(s.points(size, "warm"), m=cfg["pred_m"])
    return s


class Session:
    def __init__(self, run, emu, X, Y):
        self.run, self.emu, self.X, self.Y = run, emu, X, Y
        self.sizes = request_sizes(run)
        self.rng = run.rng("points")
        self.checked = run.checked_units()
        self.judged = []
        self.cur = None
        self.hooks = Hooks()
        from dgp_tpu_torch.vecchia import nn as vnn

        def query(original, q, x, cent, buckets, m):
            out = original(q, x, cent, buckets, m)
            if self.cur is not None:
                self.cur["nn"].append((q, x, out))
            return out
        self.hooks.add(vnn, "_ivf_query", query)

    def points(self, size, purpose=None):
        lo, hi = self.run.config["data"]["domain"]
        rng = self.rng if purpose is None else self.run.rng(purpose)
        return lo + (hi - lo) * rng.rand(int(size), self.run.config["data"]["input_dim"])

    def unit(self, i):
        x = self.points(self.sizes[i % len(self.sizes)])
        self.cur = {"x": x, "nn": []} if i in self.checked else None
        mu, var = self.emu.predict(x, m=self.run.config["pred_m"])
        if self.cur is not None:
            self.cur.update(mu=mu[:, 0], var=var[:, 0])
            self.judged.append(self.cur)
        self.cur = None
        return {"points": len(x), "requests": 1}

    def finish(self):
        """Keep the imputations and hyper-parameters; free the emulator."""
        self.hooks.remove()
        dev = self.run.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)
        self.state = []
        for imp in self.emu.all_layer_set:
            a, b = imp[0][0], imp[1][0]
            self.state.append({
                "f": t(a.output[:, 0]),
                "l0": (float(a.scale[0]), t(a.length), float(a.nugget[0])),
                "l1": (float(b.scale[0]), t(b.length), float(b.nugget[0]))})
        self.emu = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _predict(self, x, nns):
        """The reference's mixture mean and variance at x from the captured
        neighbour sets: per query chunk, layer 0's, then each imputation's
        layer 1's."""
        dev = self.run.device
        X = torch.as_tensor(self.X, dtype=torch.float64, device=dev)
        Y = torch.as_tensor(self.Y[:, 0], dtype=torch.float64, device=dev)
        x = torch.as_tensor(x, dtype=torch.float64, device=dev)
        N = len(self.state)
        calls = iter(nns)
        means, variances = [], []
        start = 0
        while start < x.shape[0]:
            nn0 = next(calls)[2]
            c = slice(start, start + nn0.shape[0])
            nn0 = torch.where(nn0 >= 0, nn0, 0)
            mc, vc = [], []
            for st in self.state:
                s0, l0, g0 = st["l0"]
                m0, v0 = ref.gp_vecch(x[c], X, nn0, st["f"], s0, l0, g0, "sexp")
                nn1 = next(calls)[2]
                nn1 = torch.where(nn1 >= 0, nn1, 0)
                s1, l1, g1 = st["l1"]
                m1, v1 = ref.link_vecch(m0[:, None], v0.abs()[:, None], x[c],
                                        st["f"][:, None], X, nn1, Y, s1, l1, g1)
                mc.append(m1)
                vc.append(v1)
            means.append(torch.stack(mc))
            variances.append(torch.stack(vc))
            start = c.stop
        if next(calls, None) is not None or len(means[0]) != N:
            raise RuntimeError("the captured neighbour sets do not match the request")
        return ref.mixture(torch.cat(means, 1), torch.cat(variances, 1))

    def check(self):
        limits = self.run.spec["limits"]
        gaps = []
        hits, total = {}, {}
        for req in self.judged:
            mu, var = self._predict(req["x"], req["nn"])
            gaps.append(ref.gap(*(torch.as_tensor(req[k], dtype=torch.float64, device=mu.device)
                                  for k in ("mu", "var")), mu, var))
            per_chunk = 1 + len(self.state)
            for j, (q, w, got) in enumerate(req["nn"]):
                exact = ref.exact_nn(q.to(torch.float64), w.to(torch.float64), got.shape[1])
                key = j % per_chunk       # layer 0's search, then each imputation's
                hits[key] = hits.get(key, 0) + int((exact[:, :, None] == got[:, None, :])
                                                   .any(-1).sum())
                total[key] = total.get(key, 0) + exact.numel()
        misses = {k: 1.0 - hits[k] / total[k] for k in total}
        log(f"nn_miss by search (0: layer 0, i: layer 1 of imputation i - 1): {misses}")
        return [{"name": "predict_gap", "value": max(gaps) if gaps else float("inf"),
                 "limit": limits["predict_gap"]},
                {"name": "nn_miss", "value": max(misses.values()) if misses else float("inf"),
                 "limit": limits["nn_miss"]}]
