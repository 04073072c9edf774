"""Prior path sampling from a DGP structure (reference `dgpsi/synthetic.py`);
the counterpart of `dgp_tpu/models/synthetic.py`.

Each layer's realisation is a draw of the GP prior on the previous
layer's draw: the correlation matrix and its factor on the device
(`ops.kernels.k_matrix`, `ops.linalg.safe_cholesky`), the standard normals
from numpy's global generator, as in the JAX package, so both packages
draw the same paths under one ``np.random.seed``.
"""
import copy

import numpy as np
import torch

from .. import config
from ..ops import kernels as kops
from ..ops import linalg


class path:
    """Prior realisations of a DGP hierarchy at inputs X (M, D), drawn
    layer by layer on ``device`` (default: the card)."""

    def __init__(self, X, all_layer, device=None):
        self.X = np.asarray(X, config.np_dtype())
        self.device = config.resolve_device(device)
        self.n_layer = len(all_layer)
        self.all_layer = copy.deepcopy(all_layer)
        for layer in self.all_layer:
            for node in layer:
                if getattr(node, 'connect', None) is not None:
                    node.global_input = self.X[:, node.connect].copy()

    def generate(self, N):
        """N realisations of the final layer: (n_out, N, M)."""
        d = len(self.all_layer[-1])
        m = len(self.X)
        dt = config.default_dtype()
        out_record = np.empty((N, m, d))
        for i in range(N):
            x = self.X
            for layer in self.all_layer:
                out = np.empty((m, len(layer)))
                for k, node in enumerate(layer):
                    In = x[:, node.input_dim] if node.input_dim is not None else x
                    if node.connect is not None:
                        In = np.concatenate((In, node.global_input), axis=1)
                    K = kops.k_matrix(torch.as_tensor(In, dtype=dt, device=self.device),
                                      torch.as_tensor(node.length, dtype=dt,
                                                      device=self.device),
                                      0.0, node.name)
                    K = kops.set_diag(K, 1.0)
                    cov = float(node.scale[0]) * (
                        K + float(node.nugget[0]) * torch.eye(m, dtype=dt, device=self.device))
                    L = linalg.safe_cholesky(cov).cpu().numpy()
                    out[:, k] = (L @ np.random.normal(size=(m, 1))).flatten()
                x = out
            out_record[i] = x
        return out_record.transpose(2, 0, 1)
