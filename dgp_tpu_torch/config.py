"""Global configuration for dgp_tpu_torch.

Mirrors `dgp_tpu/config.py`: Gaussian-process kernel matrices are
conditioned by the nugget, so float64 is the default working dtype, and no
float32 product may silently drop to TF32 (about three decimal digits).  The
Vecchia path can run in float32 via ``set_default_dtype('float32')``; its
blocks then carry the fixed jitter of `vecchia.core._f32_jitter`.
"""
import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEFAULT_DTYPE = torch.float64


def set_default_dtype(dtype):
    """Set the working dtype for model state ('float32' or 'float64', or a
    torch dtype)."""
    global _DEFAULT_DTYPE
    if isinstance(dtype, str):
        dtype = {'float32': torch.float32, 'float64': torch.float64}[dtype]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype: {dtype}")
    _DEFAULT_DTYPE = dtype


def default_dtype():
    """The package-wide working dtype (see :func:`set_default_dtype`)."""
    return _DEFAULT_DTYPE


def np_dtype():
    """The numpy counterpart of :func:`default_dtype`, for host arrays."""
    return np.float64 if _DEFAULT_DTYPE == torch.float64 else np.float32


def resolve_device(device=None):
    """A torch.device for ``device``.  The default is the current CUDA
    device; without one it raises and asks for ``device='cpu'``.  Nothing in
    the package moves work to the CPU behind the caller's back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: dgp_tpu_torch runs "
                               "on the card by default; pass device='cpu' to "
                               "run on the CPU")
        return torch.device('cuda', torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


# Numerical knobs --------------------------------------------------------
#: multiples of mean(diag) tried (in order) when a Cholesky factorisation
#: produces non-finite values.
CHOLESKY_JITTERS = (0.0, 1e-12, 1e-10, 1e-8, 1e-6, 1e-4)

#: speculative candidates evaluated per ESS rejection round (one batched
#: likelihood evaluation per round; see ess.py).  Starting values copied
#: from the JAX package, where they were tuned on other hardware; they are
#: not yet tuned for the port.
ESS_SPEC = 8
ESS_SPEC_LARGE = 4
ESS_SPEC_LARGE_THRESHOLD = 50_000


def ess_spec(n):
    """Speculative ESS width for a model with n data points."""
    return ESS_SPEC_LARGE if n >= ESS_SPEC_LARGE_THRESHOLD else ESS_SPEC


#: cap on the per-node M-step function-evaluation budget (the reference
#: hands scipy L-BFGS-B maxfun = max(30, 20 + 5D)); copied from the JAX
#: package, which validated it against the reference-anchored parity
#: matrix: a stochastic-EM M-step needs an improvement step, not
#: convergence, and each node restarts warm from the last iteration.
MSTEP_MAXFUN_CAP = 16
