"""Non-Gaussian likelihood nodes: Poisson, Hetero, NegBin, Categorical,
ZIP, ZINB; the counterpart of `dgp_tpu/likelihoods.py`.

API mirror of reference `dgpsi/likelihood_class.py` (class names, llik /
pllik / prediction / sampling methods, Hetero's exact conditional
posterior).  The classes are host code on numpy and scipy.  Each has a
matching tensor log-likelihood (`*_llik(f, y, ...)`) that the
ESS-within-Gibbs sampler evaluates on the engine's device, written with
numerically stable primitives (logsigmoid instead of log(expit),
logaddexp, log_ndtr).  The tensor functions take ``f`` as (..., n, Q): the
leading axes carry the candidates of an ESS round through one call, and
the result has their shape.
"""
import numpy as np
import torch
from scipy.special import gammaln, expit, log_ndtr, ndtr
from torch.nn.functional import logsigmoid

from .ops.special import owens_t
from .ops.linalg import sum64 as _sum64


# ======================================================================
# tensor log-likelihoods (f: (..., n, Q) latent inputs, y: (n, 1))
# ======================================================================
def _softplus(x):
    # exact in the tail, unlike torch.nn.functional.softplus's threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def poisson_llik(f, y):
    f0 = f[..., 0]
    yv = y[:, 0]
    return _sum64(yv * f0 - torch.exp(f0) - torch.lgamma(yv + 1.0), dim=-1)


def hetero_llik(f, y):
    mu, log_var = f[..., 0], f[..., 1]
    r2 = (y[:, 0] - mu) ** 2
    return _sum64(-0.5 * (np.log(2.0 * np.pi) + log_var + r2 * torch.exp(-log_var)),
                  dim=-1)


def _log_negbin(f1, f2, yv):
    n = torch.exp(-f2)
    a = f1 + f2
    return (torch.lgamma(yv + n) - torch.lgamma(n) - torch.lgamma(yv + 1.0)
            + yv * a - (yv + n) * _softplus(a))


def negbin_llik(f, y):
    return _sum64(_log_negbin(f[..., 0], f[..., 1], y[:, 0]), dim=-1)


def categorical_llik(f, y, *, num_classes, link, robustmax_eps=1e-3):
    yv = y[:, 0]
    if num_classes == 2:
        f0 = f[..., 0]
        if link == "logit":
            return _sum64(yv * f0 - _softplus(f0), dim=-1)
        log_ndtr_t = torch.special.log_ndtr
        return _sum64(yv * log_ndtr_t(f0) + (1.0 - yv) * log_ndtr_t(-f0), dim=-1)
    labels = yv.long()
    if link == "robustmax":
        correct = torch.argmax(f, dim=-1) == labels
        hit, miss = f.new_tensor([np.log(1.0 - robustmax_eps),
                                  np.log(robustmax_eps / (num_classes - 1))])
        return _sum64(torch.where(correct, hit, miss), dim=-1)
    idx = labels.expand(f.shape[:-1])[..., None]
    picked = torch.take_along_dim(f, idx, dim=-1)[..., 0]
    return _sum64(picked - torch.logsumexp(f, dim=-1), dim=-1)


def zip_llik(f, y):
    yv = y[:, 0]
    f_lam, f_pi = f[..., 0], f[..., 1]
    lam = torch.exp(f_lam)
    log_pi = logsigmoid(f_pi)         # log(pi)
    log_1m_pi = logsigmoid(-f_pi)     # log(1 - pi)
    ll_zero = torch.logaddexp(log_pi, log_1m_pi - lam)
    ll_pos = log_1m_pi - lam + yv * f_lam - torch.lgamma(yv + 1.0)
    return _sum64(torch.where(yv == 0, ll_zero, ll_pos), dim=-1)


def zinb_llik(f, y):
    yv = y[:, 0]
    f_pi = f[..., 2]
    log_nb = _log_negbin(f[..., 0], f[..., 1], yv)
    log_pi = logsigmoid(f_pi)
    log_1m_pi = logsigmoid(-f_pi)
    ll_zero = torch.logaddexp(log_pi, log_1m_pi + log_nb)
    return _sum64(torch.where(yv == 0, ll_zero, log_1m_pi + log_nb), dim=-1)


def llik_fn(name, **kw):
    """The tensor log-likelihood of a likelihood node's name."""
    if name == "Poisson":
        return poisson_llik
    if name == "Hetero":
        return hetero_llik
    if name == "NegBin":
        return negbin_llik
    if name == "ZIP":
        return zip_llik
    if name == "ZINB":
        return zinb_llik
    if name == "Categorical":
        return lambda f, y: categorical_llik(f, y, **kw)
    raise ValueError(f"unknown likelihood: {name}")


# ======================================================================
# likelihood node classes (reference API)
# ======================================================================
class _LikBase:
    def __init__(self, input_dim=None):
        self.type = 'likelihood'
        self.input = None
        self.output = None
        self.input_dim = None if input_dim is None else np.asarray(input_dim)
        self.exact_post_idx = None
        self.rep = None

    def llik(self):
        return float(self._llik_np(self.input, self.output))


class Poisson(_LikBase):
    """Poisson likelihood node (likelihood_class.py:8)."""
    name = 'Poisson'
    n_latent = 1

    @staticmethod
    def _llik_np(f, y):
        return np.sum(y[:, 0] * f[:, 0] - np.exp(f[:, 0]) - gammaln(y[:, 0] + 1.0))

    @staticmethod
    def pllik(y, f):
        return y * f - np.exp(f) - gammaln(y + 1.0)

    @staticmethod
    def prediction(m, v):
        y_mean = np.exp(m + v / 2)
        y_var = np.exp(m + v / 2) + (np.exp(v) - 1) * np.exp(2 * m + v)
        return y_mean.flatten(), y_var.flatten()

    def sampling(self, f_sample):
        return np.random.poisson(np.exp(f_sample)).flatten()


class Hetero(_LikBase):
    """Heteroskedastic Gaussian likelihood node (likelihood_class.py:92).

    The mean parameter has an exact Gaussian conditional posterior
    (`exact_post_idx = [0]`), exploited by the node-wise Gibbs sampler.
    """
    name = 'Hetero'
    n_latent = 2

    def __init__(self, input_dim=None):
        super().__init__(input_dim)
        self.exact_post_idx = np.array([0])

    @staticmethod
    def _llik_np(f, y):
        mu, log_var = f[:, 0], f[:, 1]
        r2 = (y[:, 0] - mu) ** 2
        return np.sum(-0.5 * (np.log(2 * np.pi) + log_var + r2 * np.exp(-log_var)))

    @staticmethod
    def pllik(y, f):
        mu, var = f[:, :, [0]], np.exp(f[:, :, [1]])
        return -0.5 * (np.log(2 * np.pi * var) + (y - mu) ** 2 / var)

    @staticmethod
    def prediction(m, v):
        y_mean = m[:, 0]
        y_var = np.exp(m[:, 1] + v[:, 1] / 2) + v[:, 0]
        return y_mean.flatten(), y_var.flatten()

    @staticmethod
    def sampling(f_sample):
        return np.random.normal(f_sample[:, 0], np.sqrt(np.exp(f_sample[:, 1]))).flatten()

    # The exact conditional posterior of the mean (likelihood_class.py:134,
    # post_het1/post_het2) lives in the engine: the dense draw is
    # `CompiledDGP._post_het` (models/compiled.py) and the sparse Vecchia
    # joint factor `vecchia.core.post_het_vecch`.  `exact_post_idx` above is
    # the flag those samplers key on.


class NegBin(_LikBase):
    """Negative-Binomial likelihood node (likelihood_class.py:245)."""
    name = 'NegBin'
    n_latent = 2

    @staticmethod
    def _llik_np(f, y):
        yv, f1, f2 = y[:, 0], f[:, 0], f[:, 1]
        n = np.exp(-f2)
        a = f1 + f2
        sp = np.logaddexp(0.0, a)
        return np.sum(gammaln(yv + n) - gammaln(n) - gammaln(yv + 1.0) + yv * a - (yv + n) * sp)

    @staticmethod
    def pllik(y, f):
        f1, f2 = f[:, :, [0]], f[:, :, [1]]
        n = np.exp(-f2)
        a = f1 + f2
        sp = np.logaddexp(0.0, a)
        return gammaln(y + n) - gammaln(n) - gammaln(y + 1.0) + y * a - (y + n) * sp

    @staticmethod
    def prediction(m, v):
        y_mean = np.exp(m[:, 0] + v[:, 0] / 2)
        y_var = (np.exp(2 * m[:, 0] + v[:, 0]) * (np.exp(v[:, 0]) - 1)
                 + np.exp(m[:, 0] + v[:, 0] / 2)
                 + np.exp(m[:, 1] + v[:, 1] / 2) * np.exp(2 * m[:, 0] + 2 * v[:, 0]))
        return y_mean.flatten(), y_var.flatten()

    @staticmethod
    def sampling(f_sample):
        p = 1 / (1 + np.exp(f_sample[:, 0] + f_sample[:, 1]))
        k = np.exp(-f_sample[:, 1])
        return np.random.negative_binomial(k, p).flatten()


class Categorical(_LikBase):
    """Categorical likelihood for binary / multi-class classification
    (likelihood_class.py:294)."""
    name = 'Categorical'

    def __init__(self, num_classes=None, input_dim=None, link=None, robustmax_eps=1e-3):
        super().__init__(input_dim)
        self.num_classes = num_classes
        self.class_encoder = None
        self.link = link
        self.robustmax_eps = robustmax_eps

    def _llik_np(self, f, y):
        if self.num_classes == 2:
            f0, yv = f[:, 0], y[:, 0]
            if self.link == 'logit':
                return np.sum(yv * f0 - np.logaddexp(0, f0))
            return np.sum(yv * log_ndtr(f0) + (1 - yv) * log_ndtr(-f0))
        yv = y.flatten().astype(int)
        if self.link == 'robustmax':
            K, eps = self.num_classes, self.robustmax_eps
            correct = np.argmax(f, axis=1) == yv
            return np.sum(np.where(correct, np.log(1 - eps), np.log(eps / (K - 1))))
        mx = np.max(f, axis=1, keepdims=True)
        lse = np.log(np.sum(np.exp(f - mx), axis=1)) + mx.flatten()
        return np.sum(f[np.arange(len(yv)), yv] - lse)

    def pllik(self, y, f):
        if self.num_classes == 2:
            if self.link == 'logit':
                return y * f - np.logaddexp(0, f)
            return y * log_ndtr(f) + (1 - y) * log_ndtr(-f)
        yv = y.flatten().astype(int)
        if self.link == 'robustmax':
            K, eps = self.num_classes, self.robustmax_eps
            k_star = np.argmax(f, axis=2)
            correct = k_star == yv[:, None]
            return np.where(correct, np.log(1 - eps), np.log(eps / (K - 1)))[:, :, None]
        mx = np.max(f, axis=2, keepdims=True)
        lse = np.log(np.sum(np.exp(f - mx), axis=2)) + np.squeeze(mx, axis=2)
        return (f[np.arange(len(yv)), :, yv] - lse)[:, :, None]

    def prediction(self, m, v):
        if self.num_classes == 2:
            m, v = m.flatten(), v.flatten()
            if self.link == 'logit':
                denom = 1.0 + (np.pi / 8.0) * v
                mu_star = m / np.sqrt(denom)
                y_mean = expit(mu_star)
                var_star = v / denom
                y_var = (y_mean * (1 - y_mean)) ** 2 * var_star
                y_var = np.clip(y_var, 0.0, y_mean * (1 - y_mean))
            else:
                t = m / np.sqrt(1.0 + v)
                y_mean = ndtr(t)
                a = 1.0 / np.sqrt(1.0 + 2.0 * v)
                Ep2 = y_mean - 2.0 * owens_t(t, a)
                y_var = np.maximum(Ep2 - y_mean ** 2, 0.0)
            return y_mean.reshape(-1, 1), y_var.reshape(-1, 1)
        K = self.num_classes
        S = 1000
        std = np.sqrt(np.maximum(v, 0.0))
        if self.link == 'robustmax':
            eps = self.robustmax_eps
            win = np.zeros((m.shape[0], K))
            done = 0
            while done < S:
                this = min(200, S - done)
                fc = m[:, None, :] + std[:, None, :] * np.random.randn(m.shape[0], this, K)
                ks = np.argmax(fc, axis=2)
                np.add.at(win, (np.arange(m.shape[0])[:, None], ks), 1.0)
                done += this
            q = win / S
            a, b = 1.0 - eps, eps / (K - 1)
            return b + (a - b) * q, (a - b) ** 2 * q * (1 - q)
        sum_p = np.zeros((m.shape[0], K))
        sum_p2 = np.zeros((m.shape[0], K))
        done = 0
        while done < S:
            this = min(200, S - done)
            half = (this + 1) // 2
            eps_half = np.random.randn(m.shape[0], half, K)
            noise = np.concatenate([eps_half, -eps_half], axis=1)[:, :this, :]
            fs = m[:, None, :] + std[:, None, :] * noise
            fs -= np.max(fs, axis=2, keepdims=True)
            np.exp(fs, out=fs)
            fs /= np.sum(fs, axis=2, keepdims=True)
            sum_p += fs.sum(axis=1)
            sum_p2 += (fs * fs).sum(axis=1)
            done += this
        y_mean = sum_p / S
        return y_mean, sum_p2 / S - y_mean ** 2

    def sampling(self, f_sample):
        if self.num_classes == 2:
            return expit(f_sample) if self.link == 'logit' else ndtr(f_sample)
        if self.link == 'robustmax':
            K, eps = self.num_classes, self.robustmax_eps
            ks = np.argmax(f_sample, axis=1)
            out = np.full_like(f_sample, eps / (K - 1), dtype=float)
            out[np.arange(len(f_sample)), ks] = 1.0 - eps
            return out
        e = np.exp(f_sample - np.max(f_sample, axis=1, keepdims=True))
        return e / np.sum(e, axis=1, keepdims=True)


class ZIP(_LikBase):
    """Zero-Inflated Poisson likelihood node (likelihood_class.py:470)."""
    name = 'ZIP'
    n_latent = 2

    @staticmethod
    def _llik_np(f, y):
        yv = y[:, 0]
        f_lam, f_pi = f[:, 0], f[:, 1]
        lam = np.exp(f_lam)
        log_pi = -np.logaddexp(0, -f_pi)
        log_1m_pi = -np.logaddexp(0, f_pi)
        ll_zero = np.logaddexp(log_pi, log_1m_pi - lam)
        ll_pos = log_1m_pi - lam + yv * f_lam - gammaln(yv + 1.0)
        return np.sum(np.where(yv == 0, ll_zero, ll_pos))

    @staticmethod
    def pllik(y, f):
        eta_lam, eta_pi = f[..., 0][..., None], f[..., 1][..., None]
        lam = np.exp(eta_lam)
        log_pi = -np.logaddexp(0, -eta_pi)
        log_1m_pi = -np.logaddexp(0, eta_pi)
        y_b = np.broadcast_to(y, lam.shape)
        ll_zero = np.logaddexp(log_pi, log_1m_pi - lam)
        ll_pos = log_1m_pi - lam + y_b * eta_lam - gammaln(y_b + 1.0)
        return np.where(y_b == 0, ll_zero, ll_pos)

    @staticmethod
    def prediction(m, v):
        m_lam, v_lam, m_pi, v_pi = m[:, 0], v[:, 0], m[:, 1], v[:, 1]
        lam_mean = np.exp(m_lam + 0.5 * v_lam)
        lam_var = (np.exp(v_lam) - 1.0) * np.exp(2 * m_lam + v_lam)
        denom = np.maximum(1.0 + (np.pi / 8.0) * v_pi, 1e-12)
        pi_mean = expit(m_pi / np.sqrt(denom))
        pi_var = np.clip((pi_mean * (1 - pi_mean)) ** 2 * (v_pi / denom),
                         0.0, pi_mean * (1 - pi_mean))
        y_mean = (1 - pi_mean) * lam_mean
        cond_var = (1 - pi_mean) * lam_mean * (1 + pi_mean * lam_mean)
        var_g = ((1 - pi_mean) ** 2 + pi_var) * lam_var + pi_var * lam_mean ** 2
        return y_mean.flatten(), np.maximum(cond_var + var_g, 0.0).flatten()

    def sampling(self, f_sample):
        lam = np.exp(f_sample[:, 0])
        pi = expit(f_sample[:, 1])
        u = np.random.rand(len(f_sample))
        return np.where(u < pi, 0, np.random.poisson(lam)).flatten()


class ZINB(_LikBase):
    """Zero-Inflated Negative-Binomial likelihood node (likelihood_class.py:624)."""
    name = 'ZINB'
    n_latent = 3

    @staticmethod
    def _llik_np(f, y):
        yv = y[:, 0]
        f1, f2, f_pi = f[:, 0], f[:, 1], f[:, 2]
        n = np.exp(-f2)
        a = f1 + f2
        log_nb = (gammaln(yv + n) - gammaln(n) - gammaln(yv + 1.0)
                  + yv * a - (yv + n) * np.logaddexp(0.0, a))
        log_pi = -np.logaddexp(0, -f_pi)
        log_1m_pi = -np.logaddexp(0, f_pi)
        ll_zero = np.logaddexp(log_pi, log_1m_pi + log_nb)
        ll_pos = log_1m_pi + log_nb
        return np.sum(np.where(yv == 0, ll_zero, ll_pos))

    @staticmethod
    def pllik(y, f):
        f1 = f[..., 0:1]
        f2 = f[..., 1:2]
        f_pi = f[..., 2:3]
        n = np.exp(-f2)
        a = f1 + f2
        y_b = np.broadcast_to(y, n.shape)
        log_nb = (gammaln(y_b + n) - gammaln(n) - gammaln(y_b + 1.0)
                  + y_b * a - (y_b + n) * np.logaddexp(0.0, a))
        log_pi = -np.logaddexp(0, -f_pi)
        log_1m_pi = -np.logaddexp(0, f_pi)
        ll_zero = np.logaddexp(log_pi, log_1m_pi + log_nb)
        return np.where(y_b == 0, ll_zero, log_1m_pi + log_nb)

    @staticmethod
    def prediction(m, v):
        m1, v1, m2, v2, m_pi, v_pi = m[:, 0], v[:, 0], m[:, 1], v[:, 1], m[:, 2], v[:, 2]
        mu_mean = np.exp(m1 + 0.5 * v1)
        mu_var = (np.exp(v1) - 1.0) * np.exp(2 * m1 + v1)
        mu2_mean = np.exp(2 * m1 + 2 * v1)
        mu2_over_n = mu2_mean * np.exp(m2 + 0.5 * v2)
        denom = np.maximum(1.0 + (np.pi / 8.0) * v_pi, 1e-12)
        pi_mean = expit(m_pi / np.sqrt(denom))
        pi_var = np.clip((pi_mean * (1 - pi_mean)) ** 2 * (v_pi / denom),
                         0.0, pi_mean * (1 - pi_mean))
        y_mean = (1 - pi_mean) * mu_mean
        E_pi1m = np.clip(pi_mean * (1 - pi_mean) - pi_var, 0.0, pi_mean * (1 - pi_mean))
        cond_var = (1 - pi_mean) * (mu_mean + mu2_over_n) + E_pi1m * mu2_mean
        var_g = ((1 - pi_mean) ** 2 + pi_var) * mu_var + pi_var * mu_mean ** 2
        return y_mean.flatten(), np.maximum(cond_var + var_g, 0.0).flatten()

    @staticmethod
    def sampling(f_sample):
        f1, f2, f_pi = f_sample[:, 0], f_sample[:, 1], f_sample[:, 2]
        k = np.exp(-f2)
        p = 1.0 / (1.0 + np.exp(f1 + f2))
        pi = expit(f_pi)
        u = np.random.rand(len(f_sample))
        return np.where(u < pi, 0, np.random.negative_binomial(k, p)).flatten()
