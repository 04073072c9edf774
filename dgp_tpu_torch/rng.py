"""Global RNG state.

As in `dgp_tpu/rng.py`: host-side sampling uses numpy's global RNG (so
``np.random.seed`` keeps working), and device-side sampling draws from one
module-level ``torch.Generator`` per device, which ``nb_seed`` resets.  The
streams differ from `jax.random`, so tests that compare the two packages
make their noise with numpy and hand it to both.
"""
import numpy as np
import torch

_seed = int(np.random.SeedSequence().entropy % (2**63))
_generators = {}


def nb_seed(value):
    """Seed numpy and every device's generator stream (parity with
    utils.nb_seed)."""
    global _seed
    np.random.seed(int(value))
    _seed = int(value)
    _generators.clear()


def next_generator(device='cpu'):
    """The generator of ``device``, created on first use from the current
    seed."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    key = str(dev)
    if key not in _generators:
        g = torch.Generator(device=dev)
        g.manual_seed(_seed)
        _generators[key] = g
    return _generators[key]
