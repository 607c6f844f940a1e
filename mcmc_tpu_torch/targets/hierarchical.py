"""Hierarchical Bayesian logistic-regression posterior (BASELINE config 5).

Port of ``mcmc_tpu/targets/hierarchical.py``. Model (dim = p + 1):
    tau          ~ N(0, 1)                      (log of the coefficient scale)
    beta_i | tau ~ N(0, e^tau),  i = 1..p
    y_j | x_j    ~ Bernoulli(sigmoid(x_j . beta))

log p(beta, tau | X, y) = sum_j [ y_j z_j - log(1 + e^{z_j}) ]        z = X beta
                        - 0.5 e^{-tau} sum beta^2 - 0.5 p tau - 0.5 tau^2 + const

    d/dbeta = X^T (y - sigmoid(z)) - beta e^{-tau}
    d/dtau  = 0.5 e^{-tau} sum beta^2 - p/2 - tau

The synthetic data set comes from the same numpy calls as the JAX
package's, so X and y are bit-identical to it. The likelihood's two
products with the (n_data, p) design matrix are the only real matrix work of
any ported target; the fused kernels inline it (csrc/targets.cuh).
"""

import numpy as np
import torch

from mcmc_tpu_torch.targets import TargetDistribution, _randn, _tag


def synthetic_data(dim: int, n_data: int, data_seed: int):
    """(X (n_data, dim - 1) float32, y (n_data,) bool), the JAX package's
    deterministic data set: X ~ N(0, 1), true beta at scale 0.5."""
    rng = np.random.default_rng(data_seed)
    X = rng.normal(size=(n_data, dim - 1)).astype(np.float32)
    beta_true = rng.normal(size=dim - 1).astype(np.float32) * 0.5
    logits = X @ beta_true
    y = rng.uniform(size=n_data) < 1.0 / (1.0 + np.exp(-logits))
    return X, y


def hierarchical_logistic(dim: int = 100, n_data: int = 256,
                          data_seed: int = 0) -> TargetDistribution:
    """dim = p + 1: p logistic coefficients + 1 log-scale hyperparameter
    (coordinate 0)."""
    p = dim - 1
    X_np, y_np = synthetic_data(dim, n_data, data_seed)
    y_np = y_np.astype(np.float32)

    def data(q):
        """X (n_data, p) and y in q's dtype on q's device, read from the
        kernels' copy of the data set (ops.padded_targets.device_data, its
        one owner on a device): X is that copy without its zero column."""
        from mcmc_tpu_torch.ops.padded_targets import device_data
        X, _, y = device_data(value_and_grad_fn.kernel_info, q.device)
        return X[:, 1:].to(q.dtype), y.to(q.dtype)

    def value_and_grad_fn(q):
        """q: (..., dim) with q[..., 0] = tau, q[..., 1:] = beta; computed
        in q's dtype, as the JAX target casts X to it."""
        Xq, yq = data(q)
        tau = q[..., 0]
        beta = q[..., 1:]
        z = beta @ Xq.T                                   # (..., n_data)
        log_lik = torch.sum(yq * z - torch.logaddexp(torch.zeros_like(z), z), dim=-1)
        inv_scale = torch.exp(-tau)
        sum_b2 = torch.sum(beta * beta, dim=-1)
        log_prior = -0.5 * inv_scale * sum_b2 - 0.5 * p * tau - 0.5 * tau * tau
        lp = log_lik + log_prior
        resid = yq - torch.sigmoid(z)
        g_beta = resid @ Xq - beta * inv_scale[..., None]
        g_tau = 0.5 * inv_scale * sum_b2 - 0.5 * p - tau
        return lp, torch.cat([g_tau[..., None], g_beta], dim=-1)

    def log_prob_fn(q):
        return value_and_grad_fn(q)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        tau = _randn(generator, (n_chains, 1), dtype) * 0.5
        beta = _randn(generator, (n_chains, p), dtype) * 0.3
        return torch.cat([tau, beta], dim=1)

    _tag(value_and_grad_fn, "hierarchical_logistic", dim, n_data=n_data,
         data_seed=data_seed, X=X_np, y=y_np)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=None,      # posterior moments not tractable
        true_cov=None,
        name=f"HierarchicalLogistic{dim}D_n{n_data}",
        description=(f"{dim}D hierarchical Bayesian logistic posterior "
                     f"({p} coefficients + log-scale, {n_data} observations) "
                     f"- funnel geometry with a matrix-product likelihood"),
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="hierarchical_logistic",
        params={"n_data": n_data, "data_seed": data_seed},
    )
