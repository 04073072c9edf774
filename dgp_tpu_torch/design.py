"""Sequential-design criteria helpers (ALM / MICE / VIGF support ops); the
counterpart of `dgp_tpu/design.py`.

Parity: `dgpsi/functions.py:244-256` (mice_var); the criteria themselves
are assembled in the gp class as in the reference.
"""
import numpy as np
import torch

from . import config
from .ops import kernels as kops
from .ops import linalg


def mice_var(x, x_extra, input_dim, connect, name, length, scale, nugget, nugget_s,
             device=None):
    """Smoothed predictive variance over a candidate design set, (M, 1);
    computed on ``device`` (default: the card)."""
    kernel_input = x[:, input_dim]
    if connect is not None:
        kernel_input = np.concatenate((kernel_input, x_extra[:, connect]), axis=1)
    kernel_nugget = max(nugget_s, float(np.atleast_1d(nugget)[0]))
    dev = config.resolve_device(device)
    dt = config.default_dtype()
    X = torch.as_tensor(np.asarray(kernel_input), dtype=dt, device=dev)
    K = kops.k_matrix(X, torch.as_tensor(np.asarray(length), dtype=dt, device=dev),
                      kernel_nugget, name)
    L = linalg.safe_cholesky(K)
    Rinv = linalg.cho_solve(L, torch.eye(X.shape[0], dtype=dt, device=dev))
    sigma2 = float(np.atleast_1d(scale)[0]) / torch.diagonal(Rinv)
    return sigma2.cpu().numpy().reshape(-1, 1)
