"""Device-mesh helpers; the counterpart of `dgp_tpu/parallel/mesh.py`.

The reference's only parallelism is chunking over process pools
(gp.ppredict, emulator.ppredict, lgp.ppredict, dgp.ptrain).  The JAX
package shards the test rows and the SEM state over a 1-D device mesh and
lets GSPMD partition the programs.  Here a mesh is a tuple of distinct
torch devices: a model on the CPU gets a one-device CPU mesh, a model on
the card every visible CUDA device, its own first.

The p* methods and ``sharded=True`` compute on the model's own device:
on a one-device mesh that is what the JAX package does too.  Splitting
the rows or the SEM state over several cards is not ported
(ROADMAP.md, Queue 1); `shard_latent_state` refuses a mesh of more than
one device, so `dgp.train(sharded=True)` never quietly trains on one card.
"""
import torch


def device_mesh():
    """Every visible CUDA device; raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for a device mesh; "
                           "a model built with device='cpu' gets a one-device "
                           "CPU mesh")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def model_mesh(device):
    """The mesh of a model that computes on ``device``: the CPU alone, or
    every visible card with ``device`` first.  A CUDA device without an
    index (``'cuda'``) is the current card, so it appears once."""
    device = torch.device(device)
    if device.type == "cpu":
        return (device,)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return (device,) + tuple(d for d in device_mesh() if d != device)


def shard_latent_state(state, mesh):
    """The SEM state of `CompiledDGP` on the mesh: untouched on one device.
    Sharding the latent rows across several cards is not ported (ROADMAP,
    Queue 1: multi-GPU SEM training)."""
    if len(mesh) == 1:
        return state
    raise NotImplementedError(
        f"SEM training across {len(mesh)} devices is not ported to dgp_tpu_torch "
        "(ROADMAP.md, Queue 1: multi-GPU SEM training); train(sharded=True) runs "
        "on a one-device mesh only")
