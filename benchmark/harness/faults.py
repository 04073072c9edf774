"""Faults planted under the timed path, by name, to show that the
comparison catches them (the tests on the CPU; `calibrate.py --fault` on
the card, where a training cell's limits are also held against them).
Each ``plant(hooks)`` routes one of the program's functions through a
broken version; removing the hooks restores it.  One chip: no exchange
between chips to leave out."""
import torch


def _halve(parts):
    """The second half of the points' parts left out, the first half's
    counted twice: the mean taken over the rest."""
    h = parts[0].shape[-1] // 2
    return tuple(torch.cat([2 * t[..., :h], 0 * t[..., h:]], -1) for t in parts)


def state_unchanged(hooks):
    """The M-step hands back the hyper-parameters it was given."""
    from dgp_tpu_torch.models import compiled
    hooks.add_method(compiled.CompiledDGP, "_m_step",
                     lambda original, engine, latents, params, nn_state, shares=None: params)


def latents_unchanged(hooks):
    """The I-step runs its sweeps and hands back the latents it was given."""
    from dgp_tpu_torch.models import compiled

    def i_step(original, engine, latents, *args, **kwargs):
        original(engine, latents, *args, **kwargs)
        return latents
    hooks.add_method(compiled.CompiledDGP, "_i_step", i_step)


def half_the_points(hooks):
    """K1's per-point parts of half the points left out."""
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    hooks.add(cv, "block_nllik_grad_parts_t", lambda original, *a, **k: _halve(original(*a, **k)))


def answer_altered(hooks):
    """One point's log-determinant in K2's candidates' sums doubled."""
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    def altered(original, *a, **k):
        ld, q = original(*a, **k)
        ld = ld.clone()
        ld[..., 0] *= 2
        return ld, q
    hooks.add(cv, "block_loglik_multi_t", altered)


def _rows(module, attr, change):
    def plant(hooks):
        hooks.add(module, attr, lambda original, *a, **k: change(*original(*a, **k)))
    plant.__name__ = f"{attr}_{change.__name__}"
    return plant


def half_rows(mu, var):
    """Half the queries' answers left out, the other half's given twice."""
    h = (mu.shape[0] + 1) // 2
    return (torch.cat([mu[:h], mu[:mu.shape[0] - h]]),
            torch.cat([var[:h], var[:var.shape[0] - h]]))


def one_altered(mu, var):
    """One query's mean moved by a thousandth."""
    mu = mu.clone()
    mu[0] += 1e-3
    return mu, var


#: by cell: (fault, the compared number that has to catch it)
FAULTS = {
    "vsi_n1e5.sem": [(state_unchanged, "mstep_step_gap"), (latents_unchanged, "istep_latent_gap"),
                     (half_the_points, "mstep_nll_gap"), (answer_altered, "ess_ll_gap")],
    "vsi_n1e5.predict": [
        (_rows("dgp_tpu_torch.vecchia.core", "link_gp_vecch", half_rows), "predict_gap"),
        (_rows("dgp_tpu_torch.vecchia.core", "link_gp_vecch", one_altered),
         "predict_gap")],
    "lgp_n2000.predict": [
        (_rows("dgp_tpu_torch.gp_core", "linkgp_predict", half_rows), "predict_gap"),
        (_rows("dgp_tpu_torch.gp_core", "linkgp_predict", one_altered), "predict_gap")],
}


def by_name(name):
    return next(f for fs in FAULTS.values() for f, _ in fs if f.__name__ == name)
