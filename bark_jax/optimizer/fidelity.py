"""Information-based multi-fidelity selection (MES-style).

Parity: src/bark/optimizer/information_based_fidelity.py:16-167 — choose the
fidelity maximizing information gain about the target-fidelity optimum per
unit cost:

  IG_m(x) = H[f(x, m) | D] − E_{f*}[ H[f(x, m) | f*, D] ]

with the closed form for the target fidelity (truncated-Gaussian entropy)
and a 1-D trapezoid integration with adaptive range for low fidelities.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm

SQRT_2PI_E = float(np.sqrt(2 * np.pi * np.e))


def _entropy_target_fidelity(mu, sigma, f_star):
    """Parity: information_based_fidelity.py:67-87."""
    gamma = (f_star - mu) / (sigma + 1e-7)
    cdf = norm.cdf(gamma)
    pdf = norm.pdf(gamma)
    inner = SQRT_2PI_E * sigma * cdf
    log_term = np.log(np.where(inner <= 0, 1e-10, inner))
    second = gamma * pdf / (2 * cdf + 1e-10)
    return float(np.mean(log_term - second))


def _entropy_low_fidelity(mu_m, sigma_m, mu_0, sigma_0, cov_m0, f_star):
    """Parity: information_based_fidelity.py:90-167 — adaptive-range
    trapezoid integration of the conditional-entropy integrand."""
    sigma_mM_sqrd = cov_m0
    s_sqrd = max(sigma_0**2 - sigma_mM_sqrd**2 / (sigma_m**2 + 1e-9), 1e-12)

    def psi(f):
        # f: (G, 1); f_star: (N,)
        u_x = mu_0 + sigma_mM_sqrd * (f - mu_m) / (sigma_m**2 + 1e-9)
        cdf = norm.cdf((f_star[None, :] - u_x) / (np.sqrt(s_sqrd) + 1e-9))
        pdf = norm.pdf((f - mu_m) / (sigma_m + 1e-9))
        return cdf * pdf

    inv_Z = norm.cdf((f_star - mu_0) / (sigma_0 + 1e-9)) * sigma_m + 1e-10
    Z = 1.0 / inv_Z  # (N,)

    # adaptive range (information_based_fidelity.py:139-155)
    f_adapt = np.linspace(-10.0, 10.0, 100)[:, None]
    p = psi(f_adapt)
    nz = np.abs(p).sum(axis=1) > 1e-8
    if not nz.any():
        return 0.0
    lo = f_adapt[nz, 0].min() - 0.25
    hi = f_adapt[nz, 0].max() + 0.25

    f_range = np.linspace(lo, hi, 250)[:, None]
    z_phi = Z[None, :] * psi(f_range)  # (G, N)
    with np.errstate(divide="ignore", invalid="ignore"):
        grid = np.where(z_phi > 0, z_phi * np.log(z_phi), 0.0)
    integral = np.trapezoid(grid, f_range[:, 0], axis=0)  # (N,)
    return float(-np.mean(integral))


def information_gain(mogp, x, f_star: np.ndarray, fidelity: int) -> float:
    """IG of observing x at the given fidelity (target fidelity = 0).

    Parity: information_based_fidelity.py:39-64.
    """
    x = np.atleast_2d(x)
    mu_m, sigma_m = mogp.predict(x, [fidelity], predict_observed=False)
    mu_m, sigma_m = float(mu_m[0]), float(sigma_m[0])
    # work in standardized space like the reference's model outputs
    mu_m = (mu_m - mogp.scaler.mean) / mogp.scaler.std
    sigma_m = sigma_m / mogp.scaler.std

    H1 = np.log(sigma_m * SQRT_2PI_E)
    if fidelity == 0:
        H2 = _entropy_target_fidelity(mu_m, sigma_m, f_star)
    else:
        mu_joint, cov_joint = mogp._posterior_joint(
            np.vstack([x, x]), [fidelity, 0]
        )
        mu_joint = np.asarray(mu_joint)
        cov_joint = np.asarray(cov_joint)
        mu_0 = mu_joint[1]
        sigma_0 = float(np.sqrt(max(cov_joint[1, 1], 1e-12)))
        cov_m0 = float(cov_joint[0, 1])
        H2 = _entropy_low_fidelity(mu_m, sigma_m, mu_0, sigma_0, cov_m0, f_star)
    return float(H1 - H2)


def propose_fidelity_information_based(mogp, x, costs, f_star) -> int:
    """argmax over fidelities of IG(x, m) / cost_m.

    Parity: information_based_fidelity.py:16-36 (f* drawn by the caller via
    bark_jax.models.sampling.generate_fstar_samples).
    """
    igs = [
        information_gain(mogp, x, f_star, m) / costs[m]
        for m in range(len(costs))
    ]
    return int(np.argmax(igs))
