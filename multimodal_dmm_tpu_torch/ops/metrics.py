"""Evaluation metrics on the host (counterpart of
multimodal_dmm_tpu/ops/metrics.py; SSIM is in ``ops/ssim.py``)."""

import numpy as np


def eval_ccc(y_true, y_pred):
    """Concordance correlation coefficient of two 1-D arrays (numpy)."""
    true_mean = np.mean(y_true)
    true_var = np.var(y_true)
    pred_mean = np.mean(y_pred)
    pred_var = np.var(y_pred)
    covar = np.cov(y_true, y_pred, bias=True)[0][1]
    return 2 * covar / (true_var + pred_var + (pred_mean - true_mean) ** 2)
