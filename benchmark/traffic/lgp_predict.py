"""Prediction requests to a linked emulator of a feed-forward system: one
closed-loop client sends `lgp.predict(x, m=pred_m)` requests back to back.

Mix parameters: ``points`` (a request's query points, uniform on model 1's
domain).

Set-up trains model 1 (`gp.train()`), builds model 2 at the
configuration's hyper-parameters, the two containers and the system of
``lgp_N`` imputations of model 2.  The comparison follows the program's
own state (model 1's trained hyper-parameters and Vecchia ordering, model
2's imputations) and works the rest out again in float64:

  * ``predict_gap``: over the judged requests' points, the larger of
    |mean - ref mean| / ref sd and |var - ref var| / ref var, the
    reference's neighbour sets its own exact search's;
  * ``train_step_gap``: model 1's training, the start of the system: the
    norm of the change of its log-parameters against the reference
    L-BFGS's from the same start on its own exact ordered neighbours,
    relative.
"""
import gc
import time

import numpy as np
import torch

from ..harness import data, models
from ..harness.core import log
from ..reference import lbfgs as ref_lbfgs
from ..reference import predict as ref
from ..reference import vecchia as ref_v


def setup(run):
    import dgp_tpu_torch as dt
    dt.set_default_dtype(run.dtype)
    cfg = run.config
    rng = run.rng("data")
    X1, Y1 = data.design(rng, cfg["model1"]["data"])
    X2, Y2 = data.design(rng, cfg["model2"]["data"])
    nd = cfg["model1"]["node"]
    np.random.seed(run.seed_for("gp_order"))
    g = dt.gp(X1, Y1, models.layers(dt, [[{**nd, "connect": None}]])[0][0], vecchia=True,
              m=cfg["vecchia_m"], device=run.device)
    start = {"length": g.kernel.length.copy(), "nugget": g.kernel.nugget.copy(),
             "ord": g.kernel.ord.copy()}
    t0 = time.perf_counter()
    g.train()
    t1 = time.perf_counter()
    c1 = dt.container(g.export(), local_input_idx=np.array([0]), device=run.device)
    dt.nb_seed(run.seed_for("model2"))
    m2 = dt.dgp(X2, Y2, models.layers(dt, cfg["model2"]["layers"]), vecchia=True,
                m=cfg["vecchia_m"], device=run.device)
    c2 = dt.container(m2.estimate(), local_input_idx=np.array([0]), device=run.device)
    system = dt.lgp([[c1], [c2]], N=cfg["lgp_N"], device=run.device)
    s = Session(run, system, g, start, (X1, Y1, X2, Y2))
    t2 = time.perf_counter()
    system.predict(s.points("warm"), m=cfg["pred_m"])
    log(f"model 1 training {t1 - t0:.3f} s, model 2 and the system {t2 - t1:.3f} s, "
        f"warm-up request {time.perf_counter() - t2:.3f} s")
    return s


class Session:
    def __init__(self, run, system, g, start, xy):
        self.run, self.system, self.g, self.start, self.xy = run, system, g, start, xy
        self.rng = run.rng("points")
        self.checked = run.checked_units()
        self.judged = []

    def points(self, purpose=None):
        lo, hi = self.run.config["model1"]["data"]["domain"]
        rng = self.rng if purpose is None else self.run.rng(purpose)
        return lo + (hi - lo) * rng.rand(self.run.mix["points"], 1)

    def unit(self, i):
        x = self.points()
        mu, var = self.system.predict(x, m=self.run.config["pred_m"])
        if i in self.checked:
            self.judged.append({"x": x, "mu": mu[0][:, 0], "var": var[0][:, 0]})
        return {"points": len(x), "requests": 1}

    def finish(self):
        """Keep model 1's trained parameters and model 2's imputations; free
        the system."""
        k = self.g.kernel
        self.model1 = {"scale": float(k.scale[0]), "length": np.array(k.length, np.float64),
                       "nugget": float(k.nugget[0]), "ord": np.array(k.ord)}
        self.imputations = []
        for one in self.system.all_layer_set:
            layers = one[1][0].structure
            a, b = layers[0][0], layers[1][0]
            self.imputations.append({
                "f": np.array(a.output[:, 0], np.float64),
                "l0": (float(a.scale[0]), np.array(a.length, np.float64), float(a.nugget[0])),
                "l1": (float(b.scale[0]), np.array(b.length, np.float64), float(b.nugget[0]))})
        self.system = self.g = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.run.device)

    def _predict(self, x):
        cfg = self.run.config
        X1, Y1, X2, Y2 = (self._t(a) for a in self.xy)
        x = self._t(x)
        k = self.model1
        L1 = self._t(k["length"])
        nn = ref.exact_nn(x / L1, X1 / L1, cfg["pred_m"])
        mu1, v1 = ref.gp_vecch(x, X1, nn, Y1[:, 0], k["scale"], L1, k["nugget"],
                               cfg["model1"]["node"]["name"])
        v1 = v1.abs()
        means, variances = [], []
        for imp in self.imputations:
            f = self._t(imp["f"])
            s0, l0, g0 = imp["l0"]
            l0 = self._t(l0)
            nn0 = ref.exact_nn(mu1[:, None] / l0, X2 / l0, cfg["pred_m"])
            m0, v0 = ref.link_vecch(mu1[:, None], v1[:, None], None, X2, None, nn0, f, s0, l0,
                                    g0)
            s1, l1, g1 = imp["l1"]
            W = torch.stack([f, X2[:, 0]], dim=1)
            m, v = ref.link_dense(torch.stack([m0, mu1], 1), torch.stack([v0, v1], 1), W,
                                  Y2[:, 0], s1, self._t(l1), g1)
            means.append(m)
            variances.append(v)
        return ref.mixture(torch.stack(means), torch.stack(variances))

    def _train_gap(self):
        """Model 1's training against the reference's, from the same start
        on the same ordering, with the reference's exact ordered neighbours
        (its inputs scaled by the starting length, as the program's
        construction searches)."""
        cfg = self.run.config
        nd, tr = cfg["model1"]["node"], cfg["model1"]["train"]
        X1, Y1 = self._t(self.xy[0]), self._t(self.xy[1])
        o = torch.as_tensor(self.start["ord"], device=X1.device)
        Xo, yo = X1[o], Y1[o, 0]
        NN = ref_v.ordered_nn(Xo / self._t(self.start["length"]), cfg["vecchia_m"])
        obj = ref_v.NodeObjective(Xo, yo, NN, nd["name"], n_length=1, nugget_est=True,
                                  nugget=None, scale_est=True, scale=None,
                                  prior_coef=models.prior_coef(nd))
        lt0 = torch.log(self._t(np.concatenate([self.start["length"], self.start["nugget"]])))
        big = float(torch.finfo(torch.float64).max / 4)
        lb = torch.tensor([-big, np.log(tr["nugget_lower"])], dtype=torch.float64,
                          device=X1.device)
        ub = torch.full_like(lb, big)
        x, _, _, _ = ref_lbfgs.minimize(obj, lt0, lb, ub, tr["maxfun"], maxiter=tr["maxiter"],
                                        history=tr["history"])
        k = self.model1
        got = torch.log(self._t(np.concatenate([k["length"], [k["nugget"]]])))
        dr = float(torch.linalg.vector_norm(x - lt0))
        return abs(float(torch.linalg.vector_norm(got - lt0)) - dr) / dr

    def check(self):
        limits = self.run.spec["limits"]
        gaps = []
        for req in self.judged:
            mu, var = self._predict(req["x"])
            gaps.append(ref.gap(self._t(req["mu"]), self._t(req["var"]), mu, var))
        return [{"name": "predict_gap", "value": max(gaps) if gaps else float("inf"),
                 "limit": limits["predict_gap"]},
                {"name": "train_step_gap", "value": self._train_gap(),
                 "limit": limits["train_step_gap"]}]
