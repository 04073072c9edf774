"""Write dgp_tpu_torch/data/parity_wine.json: the wine rows' data for the
port's parity harness (tools/parity_torch.py), made once where
scikit-learn is installed.

It holds the arrays of `tools/parity_data.wine_data()` (the wine data,
MinMax-scaled, split 80/20 at random_state=99: Xtr, Xte, ytr, yte), the
log-loss and accuracy of scikit-learn's GaussianProcessClassifier on that
split under the protocol of `tools/parity.py:219-229` (the `wine` row's
gate compares the DGP with it), and the scikit-learn version.  JSON keeps
every float64 exactly (shortest round-trip repr).

Usage: python tools/make_torch_parity_data.py
"""
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _HERE)

import parity_data as pdata  # noqa: E402

OUT = os.path.join(_ROOT, "dgp_tpu_torch", "data", "parity_wine.json")


def main():
    import sklearn
    from sklearn.gaussian_process import GaussianProcessClassifier
    from sklearn.gaussian_process.kernels import Matern
    from sklearn.metrics import accuracy_score, log_loss

    random_state = 99
    np.random.seed(random_state)
    Xtr, Xte, ytr, yte = pdata.wine_data()
    t0 = time.time()
    ker = 1.0 * Matern([1.0] * 13, nu=2.5, length_scale_bounds=(1e-5, 1e8))
    m_gp = GaussianProcessClassifier(kernel=ker, random_state=random_state)
    m_gp.fit(Xtr, ytr)
    out = {
        "source": "tools/parity_data.py:wine_data (load_wine, MinMaxScaler, "
                  "train_test_split test_size=0.2 random_state=99); GPC as "
                  "tools/parity.py:219-229",
        "sklearn_version": sklearn.__version__,
        "Xtr": Xtr.tolist(), "Xte": Xte.tolist(),
        "ytr": ytr.tolist(), "yte": yte.tolist(),
        "sklearn_gpc_log_loss": float(log_loss(yte, m_gp.predict_proba(Xte))),
        "sklearn_gpc_accuracy": float(accuracy_score(yte, m_gp.predict(Xte))),
        "gpc_fit_s": time.time() - t0,
    }
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=0)
        fh.write("\n")
    print(json.dumps({k: v for k, v in out.items() if not isinstance(v, list)}))


if __name__ == "__main__":
    main()
