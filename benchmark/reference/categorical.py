"""The softmax Categorical likelihood, written out plainly in PyTorch: the
benchmark's reference for the likelihood layer of a deep-GP classifier
whose last hidden layer holds one latent node a class under a
``Categorical`` node.  It imports torch alone: nothing of the port and
nothing of the JAX package.

The density is dgpsi's ``Categorical.llik`` (likelihood_class.py:294) with
K >= 3 classes and the softmax link: the label y_i of site i is drawn from
softmax(f_i), f_i = (f_i1, ..., f_iK) the latents of the site, so

    log p(y | f) = sum_i (f_{i, y_i} - log sum_k exp(f_ik)).

Departures from dgpsi, none of which changes the value in exact
arithmetic: the labels are the class indices 0..K-1 (dgpsi encodes them so
with its label encoder before it trains); the density is evaluated for a
leading axis of candidate states at once (dgpsi evaluates one state a
call); each site's log-sum-exp subtracts the site's largest latent first;
and the sum over the sites is a plain float64 sum.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def loglik(f, y):
    """Softmax Categorical log-density of the labels y (n,) (class indices)
    given the latents f (..., n, K): the sum over the sites of log
    softmax(f_i)[y_i], with the leading axes of f, in float64."""
    f = f.to(torch.float64)
    top = f.max(dim=-1, keepdim=True).values
    lse = top[..., 0] + torch.log(torch.exp(f - top).sum(-1))
    labels = y.to(torch.int64).expand(f.shape[:-1])
    picked = torch.gather(f, -1, labels[..., None])[..., 0]
    return (picked - lse).sum(-1)

