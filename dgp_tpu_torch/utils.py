"""Host-side helpers of the model classes; the counterpart of the parts of
`dgp_tpu/utils.py` the port needs so far: the latent initialisers of
narrowing layers (sigmoid-kernel PCA, exact and Nystrom), the label
encoder of the Categorical likelihood and the nested-list shape check of
`lgp.set_vecchia`.  The exact kernel PCA and the
encoder stand in for scikit-learn's `KernelPCA(kernel='sigmoid')` and
`LabelEncoder`, which the JAX package imports.
"""
import numpy as np


class LabelEncoder:
    """Class labels <-> 0 .. K-1 in sorted order (``classes_``)."""

    def fit_transform(self, y):
        self.classes_, codes = np.unique(np.asarray(y), return_inverse=True)
        return codes.reshape(-1)

    def transform(self, y):
        y = np.asarray(y)
        codes = np.searchsorted(self.classes_, y)
        codes = np.clip(codes, 0, len(self.classes_) - 1)
        if not np.array_equal(self.classes_[codes], y):
            raise ValueError("y contains labels the encoder was not fitted on")
        return codes


def kernel_pca(X, n_components):
    """Scores of the largest ``n_components`` components of a kernel PCA
    with the sigmoid kernel tanh(x.x' / d + 1): the kernel matrix is
    double-centred, its eigenvectors scaled by the square roots of their
    eigenvalues, and each component's sign set so that its entry of largest
    magnitude is positive (what scikit-learn's KernelPCA returns)."""
    X = np.asarray(X)
    K = np.tanh(X @ X.T / X.shape[1] + 1.0)
    rows = K.mean(axis=0)
    K = K - rows[None, :] - rows[:, None] + rows.mean()
    lam, V = np.linalg.eigh(K)
    top = np.argsort(lam)[::-1][:n_components]
    lam, V = lam[top], V[:, top]
    V = V * np.sign(V[np.argmax(np.abs(V), axis=0), np.arange(V.shape[1])])
    return V * np.sqrt(np.maximum(lam, 0.0))


class NystromKPCA:
    """Nystrom-approximated kernel PCA with a sigmoid kernel, used to
    initialise narrowing latent layers at scale (role of reference
    utils.py:203-269; the construction here is the feature-space form).

    With landmarks Z, the Nystrom feature map is phi(x) = W^{-1/2} k(x, Z)
    where W = k(Z, Z).  Kernel PCA of the centred feature matrix
    Phi - mean(Phi) is then an ordinary PCA, computed from its SVD; the
    scores are U_r S_r.  Each component's sign is chosen so that its
    midrange is non-negative (the latent initialiser expects that
    orientation).  The landmarks come from numpy's global generator.
    """

    def __init__(self, n_components, m=200):
        self.m = m
        self.n_components = n_components

    def fit_transform(self, X):
        X = np.asarray(X)
        n, d = X.shape
        m = min(self.m, n)
        idx = np.random.permutation(n)[:m]
        Z = X[idx]
        gamma = 1.0 / d
        K_nm = np.tanh(gamma * (X @ Z.T) + 1.0)
        W = K_nm[idx]
        W = 0.5 * (W + W.T)
        lam, V = np.linalg.eigh(W)
        lam = np.maximum(lam, 1e-12)
        Phi = K_nm @ ((V / np.sqrt(lam)) @ V.T)
        Phi -= Phi.mean(axis=0)
        U, S, _ = np.linalg.svd(Phi, full_matrices=False)
        r = min(self.n_components, S.shape[0])
        scores = U[:, :r] * S[:r]
        if r < self.n_components:  # rank-deficient input: pad with zeros
            scores = np.pad(scores, ((0, 0), (0, self.n_components - r)))
        flip = (scores.min(axis=0) + scores.max(axis=0)) / 2 < 0
        return scores * np.where(flip, -1.0, 1.0)


def have_same_shape(list1, list2):
    """Whether two nested lists have the same nesting and lengths
    (reference utils.have_same_shape)."""
    if len(list1) != len(list2):
        return False
    for a, b in zip(list1, list2):
        if isinstance(a, list) and isinstance(b, list):
            if not have_same_shape(a, b):
                return False
        elif isinstance(a, list) or isinstance(b, list):
            return False
    return True
