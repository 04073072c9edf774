"""Special functions of the likelihood layer; the counterpart of
`dgp_tpu/ops/special.py`.

Owen's T function gives the probit-link categorical second moment
(reference `dgpsi/likelihood_class.py:396-404` uses scipy.special.owens_t).
It is evaluated with a fixed 48-point Gauss-Legendre rule of the defining
integral

    T(h, a) = 1/(2*pi) * int_0^a exp(-h^2 (1 + x^2) / 2) / (1 + x^2) dx,

which is smooth on the domain the package uses (0 < a <= 1).
"""
import numpy as np
import torch

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(48)
# map from [-1, 1] to [0, 1]
_GL_T = (_GL_NODES + 1.0) / 2.0
_GL_W = _GL_WEIGHTS / 2.0


def owens_t(h, a):
    """Owen's T function, elementwise with broadcasting: on tensors a
    tensor, on numpy arrays (the host-side `prediction`) a numpy array."""
    if isinstance(h, torch.Tensor) or isinstance(a, torch.Tensor):
        h = torch.as_tensor(h)
        a = torch.as_tensor(a, device=h.device)
        dt = torch.result_type(h, a)
        t = torch.as_tensor(_GL_T, dtype=dt, device=h.device)
        w = torch.as_tensor(_GL_W, dtype=dt, device=h.device)
        x = a[..., None] * t
        integrand = torch.exp(-0.5 * h[..., None] ** 2 * (1.0 + x * x)) / (1.0 + x * x)
        return a * torch.sum(w * integrand, dim=-1) / (2.0 * np.pi)
    h, a = np.asarray(h), np.asarray(a)
    x = a[..., None] * _GL_T
    integrand = np.exp(-0.5 * h[..., None] ** 2 * (1.0 + x * x)) / (1.0 + x * x)
    return a * np.sum(_GL_W * integrand, axis=-1) / (2.0 * np.pi)
