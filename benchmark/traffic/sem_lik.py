"""SEM training of a heteroskedastic deep GP as a user trains it: `dgp.train`
calls of one chunk each, back to back, after the mix's warm-up iterations
in set-up.  The model is dgpsi's three-layer Hetero DGP: one hidden GP
node; then the mean and the log-variance nodes, both fed by it and by the
global input; then a ``Hetero`` likelihood node.  Its I-step mixes three
moves a sweep: layer 0's block ESS against the two upper GP nodes (K2's
angle views), the exact Gibbs draw of the mean (`post_het_vecch`), and
the log-variance's node-wise ESS against the Hetero density.

Mix parameters: ``warm_iterations``, ``chunk``.  The configuration's
``data`` adds noise of standard deviation ``noise * exp(noise_rate * x)``.

The comparison follows the program from its own state, as `sem.py` does,
and judges the first I-step and the first M-step of each judged unit:

  * ``ess_ll_gap``: layer 0's first ESS round (K2's sums) against the
    reference's sum of the two layer-1 nodes' Vecchia log-likelihoods,
    relative;
  * ``lik_ll_gap``: the log-variance node's first ESS round against the
    reference's Hetero log-density (`reference/hetero.py`), relative;
  * ``exact_draw_gap``: the first exact draw of the mean against the
    reference's, built from an explicit sparse factor, from the same
    inputs and the same normals (the device generator's state, captured,
    replayed), relative to the largest latent;
  * ``istep_latent_gap``: the I-step replayed from its input latents,
    chained through the reference's own results: every block ESS
    transition, exact draw and node-wise ESS transition, as `sem.py`
    replays a transition, each checked against the program's, and the
    latents the I-step hands back.  Infinite where the I-step made another
    sequence than (block ESS, exact draw, node-wise ESS) once a sweep;
  * ``prior_weight_gap``: the I-step's first prior draw's conditional
    weights and deviations (K3);
  * ``mstep_nll_gap``, ``mstep_grad_gap``, ``mstep_step_gap``: the
    M-step's first objective and gradient (K1) and its result, over the
    three GP nodes, as `sem.py` measures them.
"""
import time

import numpy as np
import torch

from ..harness import data, faults, models
from ..harness.core import log
from ..reference import ess as ref_ess
from ..reference import hetero as ref_het
from ..reference import lbfgs as ref_lbfgs
from ..reference import vecchia as ref
from . import sem
from .sem import _f64, _norm_gaps

#: the moves of one sweep of the I-step, in order
SWEEP = (("ess", "block"), ("exact", None), ("ess", "nodewise"))


def design(rng, spec):
    """Inputs and noisy outputs: ``n`` points uniform on [lo, hi]^d, then
    ``function`` plus noise of standard deviation noise * exp(noise_rate *
    x) (the first input), in that order from ``rng``."""
    lo, hi = spec["domain"]
    X = lo + (hi - lo) * rng.rand(spec["n"], spec["input_dim"])
    sd = spec["noise"] * np.exp(spec["noise_rate"] * X[:, :1])
    Y = data.FUNCTIONS[spec["function"]](X) + sd * rng.randn(spec["n"], 1)
    return X, Y


def _check_shape(layers):
    gp = [[nd.get("name") != "Hetero" for nd in layer] for layer in layers]
    if gp != [[True], [True, True], [False]]:
        raise ValueError("sem_lik drives one hidden node, then a (mean, log-variance) pair, "
                         f"then Hetero; the configuration has {layers}")


def setup(run):
    import dgp_tpu_torch as dt
    dt.set_default_dtype(run.dtype)
    cfg = run.config
    _check_shape(cfg["layers"])
    X, Y = design(run.rng("data"), cfg["data"])
    layers = dt.combine(*models.layers(dt, cfg["layers"][:-1]), [dt.Hetero()])
    dt.nb_seed(run.seed_for("model"))
    t0 = time.perf_counter()
    model = dt.dgp(X, Y, layers, vecchia=True, m=cfg["vecchia_m"], device=run.device)
    t1 = time.perf_counter()
    model.train(N=run.mix["warm_iterations"], ess_burn=cfg["ess_burn"],
                chunk_size=run.mix["chunk"], disable=True)
    log(f"construction {t1 - t0:.3f} s, warm-up training {time.perf_counter() - t1:.3f} s")
    return Session(run, model, X, Y)


def _gap(prog, want):
    return float((_f64(prog) - want).abs().max() / want.abs().max())


class Session(sem.Session):
    # -- instruments, besides `sem.Session`'s
    def _install(self):
        super()._install()
        from dgp_tpu_torch.models import compiled
        from dgp_tpu_torch.vecchia import core as vcore
        s = self

        def route(name):
            def method(original, engine, *args, **kwargs):
                c = s.cur
                if c is None or c.get("stage") != "istep":
                    return original(engine, *args, **kwargs)
                c["route"] = name
                try:
                    return original(engine, *args, **kwargs)
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
                c.setdefault("events", []).append(("ess", rec))
            return out
        self.hooks.add(compiled, "ess_update", ess)

        def exact(original, gen, X, impNN, Gamma, y_eff, scale, length, nugget, name, **kw):
            c = s.cur
            if c is None or c.get("stage") != "istep":
                return original(gen, X, impNN, Gamma, y_eff, scale, length, nugget, name, **kw)
            rec = {"gen": gen.get_state(), "X": X, "impNN": impNN, "Gamma": Gamma, "y": y_eff,
                   "scale": scale, "length": length, "name": name}
            rec["out"] = original(gen, X, impNN, Gamma, y_eff, scale, length, nugget, name, **kw)
            c.setdefault("events", []).append(("exact", rec))
            return rec["out"]
        self.hooks.add(vcore, "post_het_vecch", exact)

    # -- the reference's targets, at the I-step's hyper-parameters and
    # neighbour sets
    def _data(self, device):
        return (_f64(torch.as_tensor(self.X)).to(device),
                _f64(torch.as_tensor(self.Y))[:, 0].to(device))

    def _layer1_loglik(self, st, f0, F1):
        """The two layer-1 nodes' Vecchia log-likelihoods of their targets
        F1 (n, 2) at the hidden node's latent f0 (n,)."""
        X, _ = self._data(f0.device)
        Xin = torch.stack([f0, X[:, 0]], dim=1)
        total = 0.0
        for k in range(2):
            p, ns = st["params"][1][k], st["nn_state"][1][k]
            o = ns["ord"]
            total = total + ref.loglik(Xin[o], F1[o, k], ns["NN"], _f64(p["scale"]),
                                       _f64(p["length"]), _f64(p["nugget"]),
                                       self.run.config["layers"][1][k]["name"])
        return total

    def _draw(self, st, rec, f0, logvar):
        """The reference's exact draw of the mean (in the node's ordering),
        at the hidden latent f0 and log-variance column, from the normals
        the program drew."""
        X, Y = self._data(f0.device)
        p, ns = st["params"][1][0], st["nn_state"][1][0]
        o = ns["ord"]
        Xin = torch.stack([f0, X[:, 0]], dim=1)[o]
        return ref_het.exact_draw(Xin, ns["impNN"], torch.exp(logvar)[o], Y[o],
                                  _f64(p["scale"]), _f64(p["length"]),
                                  self.run.config["layers"][1][0]["name"], self._normals(rec))

    @staticmethod
    def _normals(rec):
        X = rec["X"]
        g = torch.Generator(device=X.device)
        g.set_state(rec["gen"])
        return _f64(torch.randn((X.shape[0],), generator=g, dtype=X.dtype, device=X.device))

    # -- the compared numbers
    def _block_gap(self, st, rec):
        F1 = _f64(st["latents"][1])
        gaps = []
        for c, s, llp in zip(rec["cos"], rec["sin"], rec["ll"].tolist()):
            f0 = c * _f64(rec["f"][:, 0]) + s * _f64(rec["nu"][:, 0])
            llr = float(self._layer1_loglik(st, f0, F1))
            gaps.append(abs(llp - llr) / abs(llr))
        return max(gaps)

    def _lik_gap(self, st, rec, mean):
        _, Y = self._data(mean.device)
        gaps = []
        for c, s, llp in zip(rec["cos"], rec["sin"], rec["ll"].tolist()):
            llr = float(ref_het.loglik(mean, c * _f64(rec["f"]) + s * _f64(rec["nu"]), Y))
            gaps.append(abs(llp - llr) / abs(llr))
        return max(gaps)

    def _exact_gap(self, rec):
        want = ref_het.exact_draw(_f64(rec["X"]), rec["impNN"], _f64(rec["Gamma"]),
                                  _f64(rec["y"]), _f64(rec["scale"]), _f64(rec["length"]),
                                  rec["name"], self._normals(rec))
        return _gap(rec["out"], want)

    def _istep_gap(self, cap):
        st, events = cap["istep"], cap.get("events", [])
        sweeps = self.run.config["ess_burn"] + 1
        if [(kind, r.get("route")) for kind, r in events] != list(SWEEP) * sweeps:
            return float("inf")
        _, Y = self._data(st["latents"][0].device)
        f0 = _f64(st["latents"][0][:, 0])
        F1 = _f64(st["latents"][1]).clone()
        rev = st["nn_state"][1][0]["rev"]
        gaps = []
        for kind, rec in events:
            if kind == "exact":
                draw = self._draw(st, rec, f0, F1[:, 1])
                gaps.append(_gap(rec["out"], draw))
                F1[:, 0] = draw[rev]
                continue
            u0, t0 = ref_ess.first_uniforms(rec["gen"])
            if rec["route"] == "block":
                got = ref_ess.transition(
                    f0, _f64(rec["nu"][:, 0]),
                    lambda f: self._layer1_loglik(st, f, F1), u0, t0, rec["tried"][1:])
                if got is None:
                    return float("inf")
                f0 = got[0]
                gaps.append(_gap(rec["out"][:, 0], f0))
            else:
                mean = F1[:, 0].clone()
                got = ref_ess.transition(F1[:, 1].clone(), _f64(rec["nu"]),
                                         lambda g: ref_het.loglik(mean, g, Y), u0, t0,
                                         rec["tried"][1:])
                if got is None:
                    return float("inf")
                F1[:, 1] = got[0]
                gaps.append(_gap(rec["out"], F1[:, 1]))
        out = st["out"]
        gaps += [_gap(out[0][:, 0], f0), _gap(out[1], F1)]
        return max(gaps)

    def _objective(self, l, k, m):
        """The reference M-step objective of GP node (l, k) at the M-step's
        state."""
        nd = self.run.config["layers"][l][k]
        lat, p, ns = m["latents"], m["params"][l][k], m["nn_state"][l][k]
        X, _ = self._data(lat[0].device)
        if l == 0:
            Xin, y = X, _f64(lat[0][:, k])
        else:
            Xin, y = torch.stack([_f64(lat[0][:, 0]), X[:, 0]], dim=1), _f64(lat[1][:, k])
        o = ns["ord"]
        return ref.NodeObjective(Xin[o], y[o], ns["NN"], nd["name"], n_length=len(nd["length"]),
                                 nugget_est=nd["nugget_est"], nugget=_f64(p["nugget"]),
                                 scale_est=nd["scale_est"], scale=_f64(p["scale"]),
                                 prior_coef=models.prior_coef(nd))

    def _mstep_gaps(self, cap):
        m, fg = cap["mstep"], cap["fg"]
        cfg = self.run.config
        big = float(torch.finfo(torch.float64).max / 4)
        nll_gaps, g_p, g_r, d_p, d_r = [], [], [], [], []
        nodes = [(l, k) for l, layer in enumerate(cfg["layers"][:-1]) for k in range(len(layer))]
        for j, (l, k) in enumerate(nodes):
            nd = cfg["layers"][l][k]
            obj = self._objective(l, k, m)
            pk = len(nd["length"]) + int(nd["nugget_est"])
            nll, g, _ = obj(_f64(fg["lt"][j, :pk]))
            nll_gaps.append(abs(float(fg["nll"][j]) - float(nll)) / abs(float(nll)))
            g_p.append(_f64(fg["g"][j, :pk]))
            g_r.append(g)

            def logs(p):
                parts = [torch.log(_f64(p["length"]))]
                if nd["nugget_est"]:
                    parts.append(torch.log(_f64(p["nugget"]))[None])
                return torch.cat(parts)
            lt0 = logs(m["params"][l][k])
            lb = torch.full_like(lt0, -big)
            ub = torch.full_like(lt0, big)
            if nd["nugget_est"]:
                lb[-1] = np.log(cfg["mstep"]["nugget_lower"])
            x, _, _, _ = ref_lbfgs.minimize(obj, lt0, lb, ub, cfg["mstep"]["maxfun"],
                                            maxiter=cfg["mstep"]["maxiter"],
                                            history=cfg["mstep"]["history"])
            d_p.append(logs(m["out"][l][k]) - lt0)
            d_r.append(x - lt0)
        return max(nll_gaps), _norm_gaps(g_p, g_r), _norm_gaps(d_p, d_r)

    def check(self):
        limits = self.run.spec["limits"]
        found = {k: [] for k in limits}
        for cap in self.captures:
            if "istep" in cap:
                st = cap["istep"]
                events = cap.get("events", [])
                block = [r for kind, r in events if kind == "ess" and r["route"] == "block"]
                node = [r for kind, r in events if kind == "ess" and r["route"] == "nodewise"]
                exact = [r for kind, r in events if kind == "exact"]
                if block:
                    found["ess_ll_gap"].append(self._block_gap(st, block[0]))
                if exact:
                    found["exact_draw_gap"].append(self._exact_gap(exact[0]))
                    if node:
                        mean = _f64(exact[0]["out"])[st["nn_state"][1][0]["rev"]]
                        found["lik_ll_gap"].append(self._lik_gap(st, node[0], mean))
                found["istep_latent_gap"].append(self._istep_gap(cap))
            if "k3" in cap:
                found["prior_weight_gap"].append(self._k3_gap(cap))
            if "mstep" in cap and "fg" in cap:
                a, b, c = self._mstep_gaps(cap)
                found["mstep_nll_gap"].append(a)
                found["mstep_grad_gap"].append(b)
                found["mstep_step_gap"].append(c)
        return [{"name": k, "value": max(v) if v else float("inf"), "limit": limits[k]}
                for k, v in found.items()]


# -- faults planted under the timed path (the tests; calibration on the card)
def hetero_sign_flipped(hooks):
    """The Hetero density reads the log-variance with its sign flipped."""
    from dgp_tpu_torch import likelihoods

    def flipped(original, f, y):
        return original(torch.stack([f[..., 0], -f[..., 1]], dim=-1), y)
    hooks.add(likelihoods, "hetero_llik", flipped)


def exact_draw_blind(hooks):
    """The exact draw of the mean ignores its observations (all zero)."""
    from dgp_tpu_torch.vecchia import core as vcore

    def blind(original, gen, X, impNN, Gamma, y_eff, *args, **kwargs):
        return original(gen, X, impNN, Gamma, torch.zeros_like(y_eff), *args, **kwargs)
    hooks.add(vcore, "post_het_vecch", blind)


#: by cell: (fault, the compared number that has to catch it)
FAULTS = {"dgp3_hetero_n2000.sem": [(hetero_sign_flipped, "lik_ll_gap"),
                                    (exact_draw_blind, "exact_draw_gap"),
                                    (faults.latents_unchanged, "istep_latent_gap")]}
