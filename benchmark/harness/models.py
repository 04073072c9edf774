"""The program's objects of a configuration, built through its public API."""
import time

import numpy as np

from .core import log


def layers(dt, spec):
    """`dt.combine` of the configuration's layers of kernel nodes (``dt``:
    the port's package)."""
    def node(nd):
        prior = nd.get("prior", {"shape": 1.6, "rate": 0.3})
        return dt.kernel(length=np.array(nd["length"]), name=nd["name"], nugget=nd["nugget"],
                         scale=nd["scale"], nugget_est=nd["nugget_est"],
                         scale_est=nd["scale_est"],
                         prior_coef=np.array([prior["shape"], prior["rate"]]),
                         connect=None if nd["connect"] is None else np.array(nd["connect"]))
    return dt.combine(*[[node(nd) for nd in layer] for layer in spec])


def prior_coef(nd):
    """The gamma prior's (shape - 1, rate) on the log-parameters, as dgpsi
    adjusts them."""
    prior = nd.get("prior", {"shape": 1.6, "rate": 0.3})
    return prior["shape"] - 1.0, prior["rate"]


def sem_dgp(dt, run, X, Y):
    """The configuration's Vecchia DGP, constructed (its initial
    imputation drawn) and trained for the mix's warm-up iterations."""
    cfg = run.config
    dt.nb_seed(run.seed_for("model"))
    t0 = time.perf_counter()
    model = dt.dgp(X, Y, layers(dt, cfg["layers"]), vecchia=True, m=cfg["vecchia_m"],
                   check_rep=False, device=run.device)
    t1 = time.perf_counter()
    model.train(N=run.mix["warm_iterations"], ess_burn=cfg["ess_burn"],
                chunk_size=run.mix["chunk"], disable=True)
    log(f"construction {t1 - t0:.3f} s, warm-up training {time.perf_counter() - t1:.3f} s")
    return model
