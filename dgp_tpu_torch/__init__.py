"""dgp_tpu_torch -- the PyTorch/CUDA port of dgp_tpu.

The same model code as the JAX package (`dgp_tpu`), on tensors, with the
JAX package's Pallas kernels replaced by hand-written CUDA kernels for
NVIDIA Hopper (ops/cuda_vecchia.py, csrc/).  It has the public API of the
JAX package: the single-GP emulator `gp` (dense or Vecchia: training,
prediction, LOO, the ALM/MICE/VIGF design criteria); DGPs of dense or
Vecchia GP nodes with the ga, inv_ga and 'ref' priors, with or without a
final likelihood layer (Poisson, Hetero, NegBin, Categorical, ZIP, ZINB):
construction with the initial imputation, SEM training (`dgp.train`, block
or node-wise ESS, the exact draw of the Hetero mean), new data
(`dgp.update_xy`) and the switches to and from Vecchia; the `emulator`
(prediction by moments or sampling, every layer with ``full_layer``, LOO,
ALM/MICE/VIGF, `nllik`); linked emulation (`container`, `lgp`); prior
paths (`path`); `write`/`read`, `summary` and `read_dgpsi` (dgpsi
checkpoints); `ptrain`, the p* methods (`ppredict`, `ploo`, `pmetric`)
and ``sharded=True``, which split SEM's per-point kernel calls or the
prediction rows over every visible card with the one-card results
(`parallel/mesh.py`), and `utils.multistart`.

Every entry point runs on the current CUDA device unless its ``device``
argument says otherwise (``device='cpu'``), and raises where there is no
card; float64 is the default working dtype and TF32 is off (see
config.py).  The package never imports jax.
"""
from . import config  # noqa: F401  (sets the TF32 switches)
from .config import set_default_dtype, default_dtype  # noqa: F401
from .rng import nb_seed  # noqa: F401
from .models.node import kernel, combine  # noqa: F401
from .likelihoods import Poisson, Hetero, NegBin, Categorical, ZIP, ZINB  # noqa: F401
from .models.gp import gp  # noqa: F401
from .models.dgp import dgp  # noqa: F401
from .models.emulation import emulator  # noqa: F401
from .models.linkgp import container, lgp  # noqa: F401
from .models.synthetic import path  # noqa: F401
from .utils import write, read, summary, set_thread, get_thread  # noqa: F401
from .io_dgpsi import read_dgpsi  # noqa: F401
from .interop import layers_from_numpy  # noqa: F401

__version__ = "0.1.0"
