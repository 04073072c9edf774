"""SEM training of a deep-GP classifier as a user trains it: `dgp.train`
calls of one chunk each, back to back, after the mix's warm-up iterations
in set-up.  The model is dgpsi's classifier (`DGP_classification.ipynb`):
a wide layer of GP nodes over the inputs; then one GP node a class over
all of the wide layer's latents; then a ``Categorical`` node with the
softmax link.  Its I-step makes two moves a sweep: layer 0's block ESS
against the class nodes (K2's angle views, every latent column dynamic),
then layer 1's block ESS against the ``Categorical`` density alone (the
angle route's likelihood term with no upper GP node).

Mix parameters: ``warm_iterations``, ``chunk``.  The configuration's
``data`` gives the law of the inputs and labels (`design`).

The comparison follows the program from its own state, as `sem.py` and
`sem_lik.py` do, and judges the first I-step and the first M-step of each
judged unit:

  * ``ess_ll_gap``: layer 0's first ESS round (K2's sums over the class
    nodes) against the reference's sum of their Vecchia log-likelihoods,
    relative;
  * ``lik_ll_gap``: layer 1's first ESS round against the reference's
    softmax Categorical log-density (`reference/categorical.py`),
    relative;
  * ``istep_latent_gap``: the I-step replayed from its input latents,
    chained through the reference's own results, every block ESS
    transition of both layers checked against the program's, and the
    latents the I-step hands back.  Infinite where the I-step made another
    sequence than (block ESS of layer 0, block ESS of layer 1) a sweep;
  * ``prior_weight_gap``: the I-step's first prior draw's conditional
    weights and deviations (K3);
  * ``mstep_nll_gap``, ``mstep_grad_gap``, ``mstep_step_gap``: the
    M-step's first objective and gradient (K1) and its result, over every
    GP node, as `sem.py` measures them.
"""
import time

import numpy as np
import torch

from ..harness import faults, models
from ..harness.core import log
from ..reference import categorical as ref_cat
from ..reference import ess as ref_ess
from ..reference import vecchia as ref
from . import sem, sem_lik
from .sem import _f64
from .sem_lik import _gap

#: the moves of one sweep of the I-step, in order: (route, layer)
SWEEP = (("block", 0), ("block", 1))


def design(rng, spec):
    """Inputs, labels and the latent law: ``n`` points uniform on [lo,
    hi]^d; for each of the K classes w_k and v_k ~ N(0, I/d); f_k(x) =
    function_scale sin(2 pi x.w_k) + trend_scale (x - 0.5).v_k less its mean
    over the points; labels argmax_k (f_k + g_k) with g_k standard Gumbel,
    a draw from softmax(f).  In that order from ``rng``.  Returns X (n, d),
    Y (n, 1) (the class indices as floats) and f (n, K)."""
    n, d, K = spec["n"], spec["input_dim"], spec["classes"]
    lo, hi = spec["domain"]
    X = lo + (hi - lo) * rng.rand(n, d)
    wv = rng.randn(K, 2, d) / np.sqrt(d)
    f = (spec["function_scale"] * np.sin(2 * np.pi * X @ wv[:, 0].T)
         + spec["trend_scale"] * (X - 0.5) @ wv[:, 1].T)
    f = f - f.mean(axis=0)
    y = np.argmax(f + rng.gumbel(size=(n, K)), axis=1)
    return X, y[:, None].astype(np.float64), f


def _check_shape(layers):
    gp = [[nd.get("name") != "Categorical" for nd in layer] for layer in layers]
    if len(gp) != 3 or not all(gp[0]) or not all(gp[1]) or gp[2] != [False]:
        raise ValueError("sem_cat drives a layer of GP nodes, then a layer of GP nodes, "
                         f"then Categorical; the configuration has {layers}")


def setup(run):
    import dgp_tpu_torch as dt
    dt.set_default_dtype(run.dtype)
    cfg = run.config
    _check_shape(cfg["layers"])
    X, Y, _ = design(run.rng("data"), cfg["data"])
    K = cfg["data"]["classes"]
    if len(np.unique(Y)) != K:
        raise ValueError(f"the data hold {len(np.unique(Y))} of the {K} classes")
    lik = cfg["layers"][-1][0]
    layers = dt.combine(*models.layers(dt, cfg["layers"][:-1]),
                        [dt.Categorical(num_classes=lik["num_classes"], link=lik["link"])])
    dt.nb_seed(run.seed_for("model"))
    t0 = time.perf_counter()
    model = dt.dgp(X, Y, layers, vecchia=True, m=cfg["vecchia_m"], device=run.device)
    t1 = time.perf_counter()
    model.train(N=run.mix["warm_iterations"], ess_burn=cfg["ess_burn"],
                chunk_size=run.mix["chunk"], disable=True)
    log(f"construction {t1 - t0:.3f} s, warm-up training {time.perf_counter() - t1:.3f} s")
    return Session(run, model, X, Y)


class Session(sem.Session):
    #: the M-step's gaps over every GP node, as `sem_lik` measures them
    _mstep_gaps = sem_lik.Session._mstep_gaps

    # -- instruments: `sem.Session`'s, and each ESS record tagged with its
    # route and layer
    def _install(self):
        super()._install()
        from dgp_tpu_torch.models import compiled
        s = self

        def route(name):
            def method(original, engine, l, *args, **kwargs):
                c = s.cur
                if c is None or c.get("stage") != "istep":
                    return original(engine, l, *args, **kwargs)
                c["route"] = (name, l)
                try:
                    return original(engine, l, *args, **kwargs)
                finally:
                    c["route"] = None
            return method
        self.hooks.add_method(compiled.CompiledDGP, "_ess_block_layer", route("block"))
        self.hooks.add_method(compiled.CompiledDGP, "_ess_nodewise_layer", route("nodewise"))

        def ess(original, *args, **kwargs):
            # around `sem.Session`'s hook: tags the record it made
            c = s.cur
            before = len(c.get("ess", ())) if c is not None else 0
            out = original(*args, **kwargs)
            if c is not None and len(c.get("ess", ())) > before:
                rec = c["ess"][-1]
                rec["route"] = c.get("route")
                c.setdefault("events", []).append(rec)
            return out
        self.hooks.add(compiled, "ess_update", ess)

    # -- the reference's targets, at the I-step's hyper-parameters and
    # neighbour sets
    def _upper_loglik(self, st, F0, F1):
        """The class nodes' Vecchia log-likelihoods of their targets F1 (n,
        K) at the wide layer's latents F0 (n, d), summed."""
        total = 0.0
        for k, nd in enumerate(self.run.config["layers"][1]):
            p, ns = st["params"][1][k], st["nn_state"][1][k]
            o = ns["ord"]
            total = total + ref.loglik(F0[o], F1[o, k], ns["NN"], _f64(p["scale"]),
                                       _f64(p["length"]), _f64(p["nugget"]), nd["name"])
        return total

    def _labels(self, device):
        return torch.as_tensor(self.Y[:, 0], device=device)

    # -- the compared numbers
    def _block_gap(self, st, rec):
        F1 = _f64(st["latents"][1])
        gaps = []
        for c, s, llp in zip(rec["cos"], rec["sin"], rec["ll"].tolist()):
            llr = float(self._upper_loglik(st, c * _f64(rec["f"]) + s * _f64(rec["nu"]), F1))
            gaps.append(abs(llp - llr) / abs(llr))
        return max(gaps)

    def _lik_gap(self, rec):
        y = self._labels(rec["f"].device)
        gaps = []
        for c, s, llp in zip(rec["cos"], rec["sin"], rec["ll"].tolist()):
            llr = float(ref_cat.loglik(c * _f64(rec["f"]) + s * _f64(rec["nu"]), y))
            gaps.append(abs(llp - llr) / abs(llr))
        return max(gaps)

    def _istep_gap(self, cap):
        st, events = cap["istep"], cap.get("events", [])
        sweeps = self.run.config["ess_burn"] + 1
        if [r.get("route") for r in events] != list(SWEEP) * sweeps:
            return float("inf")
        F0 = _f64(st["latents"][0])
        F1 = _f64(st["latents"][1])
        y = self._labels(F0.device)
        gaps = []
        for rec in events:
            u0, t0 = ref_ess.first_uniforms(rec["gen"])
            if rec["route"][1] == 0:
                got = ref_ess.transition(F0, _f64(rec["nu"]),
                                         lambda f: self._upper_loglik(st, f, F1), u0, t0,
                                         rec["tried"][1:])
                if got is None:
                    return float("inf")
                F0 = got[0]
                gaps.append(_gap(rec["out"], F0))
            else:
                got = ref_ess.transition(F1, _f64(rec["nu"]),
                                         lambda f: ref_cat.loglik(f, y), u0, t0,
                                         rec["tried"][1:])
                if got is None:
                    return float("inf")
                F1 = got[0]
                gaps.append(_gap(rec["out"], F1))
        out = st["out"]
        gaps += [_gap(out[0], F0), _gap(out[1], F1)]
        return max(gaps)

    def _objective(self, l, k, m):
        """The reference M-step objective of GP node (l, k) at the M-step's
        state: the inputs under layer 0, the wide layer's latents under
        layer 1."""
        nd = self.run.config["layers"][l][k]
        lat, p, ns = m["latents"], m["params"][l][k], m["nn_state"][l][k]
        Xin = _f64(torch.as_tensor(self.X)).to(lat[0].device) if l == 0 else _f64(lat[0])
        y = _f64(lat[l][:, k])
        o = ns["ord"]
        return ref.NodeObjective(Xin[o], y[o], ns["NN"], nd["name"], n_length=len(nd["length"]),
                                 nugget_est=nd["nugget_est"], nugget=_f64(p["nugget"]),
                                 scale_est=nd["scale_est"], scale=_f64(p["scale"]),
                                 prior_coef=models.prior_coef(nd))

    def check(self):
        limits = self.run.spec["limits"]
        found = {k: [] for k in limits}
        n_gp = sum(len(layer) for layer in self.run.config["layers"][:-1])
        for cap in self.captures:
            if "istep" in cap:
                st = cap["istep"]
                first = {}
                for rec in cap.get("events", []):
                    first.setdefault(rec.get("route"), rec)
                if ("block", 0) in first:
                    found["ess_ll_gap"].append(_judged(self._block_gap, st, first[("block", 0)]))
                if ("block", 1) in first:
                    found["lik_ll_gap"].append(_judged(self._lik_gap, first[("block", 1)]))
                found["istep_latent_gap"].append(_judged(self._istep_gap, cap))
            if "k3" in cap:
                found["prior_weight_gap"].append(_judged(self._k3_gap, cap))
            # one K1 group holds every GP node (one kernel name, one m + 1)
            if "mstep" in cap and "fg" in cap and cap["fg"]["lt"].shape[0] == n_gp:
                gaps = _judged(self._mstep_gaps, cap)
                gaps = gaps if isinstance(gaps, tuple) else (gaps,) * 3
                for name, gap in zip(("mstep_nll_gap", "mstep_grad_gap", "mstep_step_gap"), gaps):
                    found[name].append(gap)
        return [{"name": k, "value": _worst(v), "limit": limits[k]} for k, v in found.items()]


def _judged(fn, *args):
    """``fn(*args)``, or infinite where the reference cannot factor the
    program's state (a state the program left not positive definite)."""
    try:
        return fn(*args)
    except torch.linalg.LinAlgError:
        return float("inf")


def _worst(values):
    """The largest of the readings; infinite where there is none, or one
    is not finite (a NaN compares false, so `max` could pass over it)."""
    if not values or not all(np.isfinite(v) for v in values):
        return float("inf")
    return max(values)


# -- faults planted under the timed path (the tests; calibration on the card)
def labels_moved(hooks):
    """The Categorical density reads every label moved by one class."""
    from dgp_tpu_torch import likelihoods

    def moved(original, f, y, *, num_classes, **kw):
        return original(f, (y + 1) % num_classes, num_classes=num_classes, **kw)
    hooks.add(likelihoods, "categorical_llik", moved)


def k2_column_dropped(hooks):
    """K2 given all but the last of the latent columns: the last one's
    views of the current state and of the prior draw read zero."""
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    def dropped(original, A, B, C, *args, dl=None, **kw):
        last = (A.shape[1] if dl is None else dl) - 1
        A, B = A.clone(), B.clone()
        A[:, last] = 0.0
        B[:, last] = 0.0
        return original(A, B, C, *args, dl=dl, **kw)
    hooks.add(cv, "block_loglik_multi_t", dropped)


#: by cell: (fault, the compared number that has to catch it)
FAULTS = {"dgp3_cat_n5000.sem": [(labels_moved, "lik_ll_gap"),
                                 (k2_column_dropped, "ess_ll_gap"),
                                 (faults.latents_unchanged, "istep_latent_gap"),
                                 (faults.state_unchanged, "mstep_step_gap")]}
