"""SEM training as a user trains a Vecchia DGP: `dgp.train` calls of one
chunk each, back to back, after the mix's warm-up iterations in set-up.

Mix parameters: ``warm_iterations``, ``chunk``.

The comparison follows the program from its own state.  SEM draws its
latent layer at random, so the reference cannot draw the same; it takes
each stage's inputs as the program held them -- latents, hyper-parameters,
orderings and neighbour sets, the ESS prior draw -- and works the stage's
output out again, in float64, after the window.  In each judged unit (the
first, and more drawn from the seed) it judges the first I-step and the
first M-step:

  * ``ess_ll_gap``: the first ESS round's candidate log-likelihoods (K2's
    sums) against the reference's, relative;
  * ``istep_latent_gap``: the I-step's latents.  The reference replays
    each of the I-step's ESS transitions (`reference/ess.py`) from the
    I-step's input latents, chained through its own results: the
    threshold and first angle from the sampler's first two uniforms (its
    host generator's state, captured), each later angle the sampler tried
    checked to lie in the bracket the reference's rejections leave, its
    own log-likelihoods deciding which is accepted.  The worst gap,
    relative to the largest latent, of each transition's latents and of
    those the I-step hands back, against the reference's; infinite where
    the I-step made another number of transitions, or the replay finds an
    angle outside its bracket or no angle it accepts;
  * ``prior_weight_gap``: the prior draw's conditional weights and
    standard deviations (K3) against the reference's, relative to the
    largest weight and to each deviation;
  * ``mstep_nll_gap`` and ``mstep_grad_gap``: the M-step's first objective
    and gradient (K1, as the optimiser gets them) at the same point, the
    value relative, the gradient as the gap between the two norms of a
    node over the larger of its reference norm and the median node's;
  * ``mstep_step_gap``: the M-step's result against the reference's
    L-BFGS run from the same start, as the gap between the norms of the
    two log-parameter changes of a node over the larger of its reference
    norm and the median node's;
  * ``nn_miss``: one less the recall of the window's first NN refresh
    (IVF at n >= 50000) against the exact ordered search, on rows drawn
    from the seed.
"""
import gc

import numpy as np
import torch

from ..harness import data, models
from ..harness.hooks import Hooks
from ..reference import ess as ref_ess
from ..reference import lbfgs as ref_lbfgs
from ..reference import vecchia as ref

#: rows of the refreshed neighbour sets whose recall is judged
NN_ROWS = 2000


def setup(run):
    import dgp_tpu_torch as dt
    dt.set_default_dtype(run.dtype)
    X, Y = data.design(run.rng("data"), run.config["data"])
    model = models.sem_dgp(dt, run, X, Y)
    return Session(run, model, X, Y)


def _f64(t):
    return torch.as_tensor(t).to(torch.float64)


def _norm_gaps(prog, refs):
    """Per node |norm(prog) - norm(ref)| over max(norm(ref), the median
    node's reference norm): the worst node's."""
    pn = [float(torch.linalg.vector_norm(p)) for p in prog]
    rn = [float(torch.linalg.vector_norm(r)) for r in refs]
    med = float(np.median(rn))
    return max(abs(a - b) / max(b, med, 1e-300) for a, b in zip(pn, rn))


class Session:
    def __init__(self, run, model, X, Y):
        self.run, self.model = run, model
        self.X, self.Y = X, Y
        self.chunk = run.mix["chunk"]
        self.checked = run.checked_units()
        self.captures, self.refresh = [], None
        self.cur, self.in_unit = None, False
        self.hooks = Hooks()
        self._install()

    # -- instruments: references to the program's stage inputs and outputs
    def _install(self):
        from dgp_tpu_torch.models import compiled, mstep
        from dgp_tpu_torch.vecchia import core as vcore
        s = self

        def staged(stage, key, fn):
            def method(original, engine, *args, **kwargs):
                c = s.cur
                if c is None or key in c or c.get("stage"):
                    return original(engine, *args, **kwargs)
                c["stage"] = stage
                try:
                    out = original(engine, *args, **kwargs)
                finally:
                    c["stage"] = None
                c[key] = fn(args, out)
                return out
            return method

        self.hooks.add_method(compiled.CompiledDGP, "_i_step", staged(
            "istep", "istep", lambda a, out: {"latents": a[0], "params": a[1],
                                              "nn_state": a[2], "out": out}))
        self.hooks.add_method(compiled.CompiledDGP, "_m_step", staged(
            "mstep", "mstep", lambda a, out: {"latents": a[0], "params": a[1],
                                              "nn_state": a[2], "out": out}))

        def ess(original, gen, f, nu, log_lik_fn, log_lik_angles=None, **kw):
            c = s.cur
            if c is None or c.get("stage") != "istep" or log_lik_angles is None:
                return original(gen, f, nu, log_lik_fn, log_lik_angles=log_lik_angles, **kw)
            rec = {"f": f, "nu": nu, "gen": gen.get_state(), "tried": []}
            c.setdefault("ess", []).append(rec)

            def angles(cosv, sinv):
                out = log_lik_angles(cosv, sinv)
                if "ll" not in rec:
                    rec.update(cos=list(cosv), sin=list(sinv), ll=out)
                rec["tried"].extend(zip(cosv, sinv))
                return out
            out = original(gen, f, nu, log_lik_fn, log_lik_angles=angles, **kw)
            rec["out"] = out[0] if kw.get("return_angle") else out
            return out
        self.hooks.add(compiled, "ess_update", ess)

        def weights(original, X, NNarray, length, nugget, name, *args, **kw):
            out = original(X, NNarray, length, nugget, name, *args, **kw)
            c = s.cur
            if c is not None and c.get("stage") == "istep" and "k3" not in c:
                c["k3"] = {"X": X, "NN": NNarray, "length": length, "nugget": nugget,
                           "name": name, "w": out[0], "sigma": out[1]}
            return out
        self.hooks.add(vcore, "cond_weights", weights)

        def fg(original, lt, *args, **kw):
            out = original(lt, *args, **kw)
            c = s.cur
            if c is not None and c.get("stage") == "mstep" and "fg" not in c:
                c["fg"] = {"lt": lt.clone(), "nll": out[0].clone(), "g": out[1].clone()}
            return out
        self.hooks.add(mstep, "_vecch_fg", fg)

        def refresh(original, engine, state, gen):
            out = original(engine, state, gen)
            if s.refresh is None and s.in_unit:
                s.refresh = {"latents": state[0], "params": state[1], "nn": out}
            return out
        self.hooks.add_method(compiled.CompiledDGP, "refresh_nn", refresh)

    def unit(self, i):
        self.cur = {"stage": None} if i in self.checked else None
        self.in_unit = True
        self.model.train(N=self.chunk, ess_burn=self.run.config["ess_burn"],
                         chunk_size=self.chunk, disable=True)
        self.in_unit = False
        if self.cur is not None:
            self.captures.append(self.cur)
        self.cur = None
        return {"iterations": self.chunk}

    def finish(self):
        self.hooks.remove()
        self.model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the comparison
    def _node_data(self, l, latents):
        """Node (l, 0)'s inputs and target, in float64 on the device."""
        X = _f64(torch.as_tensor(self.X)).to(latents[0].device)
        Y = _f64(torch.as_tensor(self.Y)).to(latents[0].device)
        if l == 0:
            return X, _f64(latents[0][:, 0])
        return torch.stack([_f64(latents[0][:, 0]), X[:, 0]], dim=1), Y[:, 0]

    def _objective(self, l, latents, params, nn_state):
        nd = self.run.config["layers"][l][0]
        Xin, y = self._node_data(l, latents)
        ns = nn_state[l][0]
        o = ns["ord"]
        p = params[l][0]
        return ref.NodeObjective(Xin[o], y[o], ns["NN"], nd["name"], n_length=len(nd["length"]),
                                 nugget_est=nd["nugget_est"], nugget=_f64(p["nugget"]),
                                 scale_est=nd["scale_est"], scale=_f64(p["scale"]),
                                 prior_coef=models.prior_coef(nd))

    def _upper_loglik(self, st):
        """The reference's ESS target of the latent layer: node (1, 0)'s
        Vecchia log-likelihood at a latent (n, 1), with the I-step's
        hyper-parameters and neighbour sets."""
        p, ns = st["params"][1][0], st["nn_state"][1][0]
        X, Y = self._node_data(1, (st["latents"][0],))
        o = ns["ord"]

        def loglik(f):
            Xn = torch.stack([_f64(f[:, 0]), X[:, 1]], dim=1)[o]
            return ref.loglik(Xn, Y[o], ns["NN"], _f64(p["scale"]), _f64(p["length"]),
                              _f64(p["nugget"]), "sexp")
        return loglik

    def _ess_gap(self, cap):
        e = cap["ess"][0]
        loglik = self._upper_loglik(cap["istep"])
        gaps = []
        for c, s, llp in zip(e["cos"], e["sin"], e["ll"].tolist()):
            llr = float(loglik(c * _f64(e["f"]) + s * _f64(e["nu"])))
            gaps.append(abs(llp - llr) / abs(llr))
        return max(gaps)

    def _istep_gap(self, cap):
        st, recs = cap["istep"], cap.get("ess", [])
        cfg = self.run.config
        if len(recs) != (cfg["ess_burn"] + 1) * (len(cfg["layers"]) - 1):
            return float("inf")
        loglik = self._upper_loglik(st)
        f = _f64(st["latents"][0])
        gaps = []

        def gap(prog, want):
            return float((_f64(prog) - want).abs().max() / want.abs().max())
        for rec in recs:
            u0, t0 = ref_ess.first_uniforms(rec["gen"])
            got = ref_ess.transition(f, _f64(rec["nu"]), loglik, u0, t0, rec["tried"][1:])
            if got is None:
                return float("inf")
            f = got[0]
            gaps.append(gap(rec["out"], f))
        gaps.append(gap(st["out"][0], f))
        return max(gaps)

    def _k3_gap(self, cap):
        k = cap["k3"]
        w, sig = ref.cond_weights(_f64(k["X"]), k["NN"], _f64(k["length"]), _f64(k["nugget"]),
                                  k["name"])
        gw = float((_f64(k["w"]) - w).abs().max() / w.abs().max())
        gs = float(((_f64(k["sigma"]) - sig).abs() / sig).max())
        return max(gw, gs)

    def _mstep_gaps(self, cap):
        m, fg = cap["mstep"], cap["fg"]
        cfg = self.run.config
        big = float(torch.finfo(torch.float64).max / 4)
        nll_gaps, g_p, g_r, d_p, d_r = [], [], [], [], []
        for j in range(len(cfg["layers"])):
            nd = cfg["layers"][j][0]
            obj = self._objective(j, m["latents"], m["params"], m["nn_state"])
            nl = len(nd["length"])
            pk = nl + int(nd["nugget_est"])
            lt = _f64(fg["lt"][j, :pk])
            nll, g, _ = obj(lt)
            nll_gaps.append(abs(float(fg["nll"][j]) - float(nll)) / abs(float(nll)))
            g_p.append(_f64(fg["g"][j, :pk]))
            g_r.append(g)
            p_in, p_out = m["params"][j][0], m["out"][j][0]

            def logs(p):
                parts = [torch.log(_f64(p["length"]))]
                if nd["nugget_est"]:
                    parts.append(torch.log(_f64(p["nugget"]))[None])
                return torch.cat(parts)
            lt0 = logs(p_in)
            lb = torch.full_like(lt0, -big)
            ub = torch.full_like(lt0, big)
            if nd["nugget_est"]:
                lb[-1] = np.log(cfg["mstep"]["nugget_lower"])
            x, _, _, _ = ref_lbfgs.minimize(obj, lt0, lb, ub, cfg["mstep"]["maxfun"],
                                            maxiter=cfg["mstep"]["maxiter"],
                                            history=cfg["mstep"]["history"])
            d_p.append(logs(p_out) - lt0)
            d_r.append(x - lt0)
        return max(nll_gaps), _norm_gaps(g_p, g_r), _norm_gaps(d_p, d_r)

    def _nn_miss(self):
        """One less the recall of the refreshed neighbour sets of node (1,
        0) (isotropic, so the search does not depend on its length) on
        rows drawn from the seed."""
        r = self.refresh
        ns = r["nn"][1][0]
        Xin, _ = self._node_data(1, r["latents"])
        Xo = Xin[ns["ord"]] / _f64(r["params"][1][0]["length"])
        NN = ns["NN"]
        n, m1 = NN.shape
        rows = torch.as_tensor(np.sort(self.run.rng("nn_rows").choice(
            np.arange(m1, n), size=min(NN_ROWS, n - m1), replace=False)), device=NN.device)
        exact = ref.ordered_nn(Xo, m1 - 1, rows)[:, 1:]
        got = NN[rows][:, 1:]
        return 1.0 - float((exact[:, :, None] == got[:, None, :]).any(-1).double().mean())

    def check(self):
        limits = self.run.spec["limits"]
        found = {k: [] for k in limits}
        for cap in self.captures:
            if "istep" in cap:
                if cap.get("ess"):
                    found["ess_ll_gap"].append(self._ess_gap(cap))
                found["istep_latent_gap"].append(self._istep_gap(cap))
            if "k3" in cap:
                found["prior_weight_gap"].append(self._k3_gap(cap))
            if "mstep" in cap and "fg" in cap:
                a, b, c = self._mstep_gaps(cap)
                found["mstep_nll_gap"].append(a)
                found["mstep_grad_gap"].append(b)
                found["mstep_step_gap"].append(c)
        if self.refresh is not None:
            found["nn_miss"].append(self._nn_miss())
        return [{"name": k, "value": max(v) if v else float("inf"), "limit": limits[k]}
                for k, v in found.items()]
