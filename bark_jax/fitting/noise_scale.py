"""Noise/scale hyperparameter random-walk proposals and priors.

Parity target: src/bark/fitting/noise_scale_proposals.py:14-156. Proposals
walk in softplus- or log-transformed space with Jacobian-corrected proposal
densities; priors are half-normal (noise 1.0, scale 5.0) on the joint path
and inverse-gamma on the default noise-only path. The step sizes mirror the
reference's effective constants (noise_scale_proposals.py:10-11 — the second
assignment overrides the first).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from bark_jax.fitting.params import SamplerParams

# parity: PROPOSAL_STEP_SIZE = np.array([1.0, 0.00000001]) (line 11 wins)
NOISE_STEP = 1.0
SCALE_STEP = 1e-8


def half_normal_logpdf(x, scale):
    """scale is the variance (src/bark/fitting/noise_scale_proposals.py:14-18)."""
    log_normal = -0.5 * (x**2) / scale - 0.5 * jnp.log(scale)
    return jnp.where(x >= 0, log_normal, -jnp.inf)


def gamma_logpdf(x, shape, rate):
    """Parity: noise_scale_proposals.py:21-28."""
    return (shape - 1) * jnp.log(x) - rate * x - gammaln(shape) + shape * jnp.log(rate)


def inverse_gamma_logpdf(x, shape, rate):
    """Parity: noise_scale_proposals.py:31-39 (note: scale = 1/rate)."""
    scale = 1.0 / rate
    return (
        -(shape + 1) * jnp.log(x) - scale / x - gammaln(shape) + shape * jnp.log(scale)
    )


def _propose_log(key, cur_value, step_size):
    """Random walk in log space (noise_scale_proposals.py:41-58)."""
    u = jax.random.normal(key, dtype=jnp.float32)
    return jnp.exp(jnp.log(cur_value + 1e-30) + step_size * u)


def _propose_softplus(key, cur_value, step_size):
    """Random walk in inverse-softplus space (noise_scale_proposals.py:61-67)."""
    u = jax.random.normal(key, dtype=jnp.float32)
    t = jnp.log(jnp.expm1(cur_value)) + step_size * u
    return jnp.log1p(jnp.exp(t))


def _softplus_log_q_sq(old, new, step_var):
    """The reference's softplus proposal-density expression for one variable.

    Parity: noise_scale_proposals.py:108-119 — the squared-difference term in
    inverse-softplus space plus the log-derivative correction terms.

    NOTE this expression is NOT a valid Hastings ratio: the Gaussian kernel
    in inverse-softplus space is symmetric, so its squared-difference term
    cancels in q(old|new)/q(new|old) and keeping it biases the stationary
    law (measured + derived in results/diagnostics/qratio_bug.md). It is
    used only under ``params.q_ratio_style == "reference"`` for
    like-for-like parity with the reference's transition kernel.
    """
    return (
        (jnp.log(jnp.expm1(old)) - jnp.log(jnp.expm1(new))) ** 2 / step_var
        + jnp.log(-jnp.expm1(-old))
        - jnp.log(-jnp.expm1(-new))
    )


def _softplus_log_jac_ratio(old, new):
    """Correct softplus-walk Hastings ratio, log q(old|new) - log q(new|old).

    With t(x) = softplus^-1(x) and a symmetric Gaussian step in t-space,
    q(y|x) = N(t(y); t(x), s^2) |t'(y)| and the kernel term cancels in the
    ratio; only the Jacobian |t'(x)| = 1/(1 - e^-x) survives:

        log q(old|new) - log q(new|old) = log t'(old) - log t'(new)
                                        = -log(-expm1(-old)) + log(-expm1(-new))

    A prior-only MH chain under this ratio reproduces the analytic
    inverse-gamma prior on every quantile (the reference's formula does
    not — results/diagnostics/qratio_bug.md).
    """
    return -jnp.log(-jnp.expm1(-old)) + jnp.log(-jnp.expm1(-new))


def get_noise_scale_proposal(
    key: jax.Array, noise: jax.Array, scale: jax.Array, params: SamplerParams
) -> tuple[tuple[jax.Array, jax.Array], jax.Array]:
    """Joint (noise, scale) proposal with log q + log prior-ratio.

    Parity: src/bark/fitting/noise_scale_proposals.py:70-156, dispatching on
    the static flags ``use_softplus_transform`` / ``sample_scale``.
    """
    k_noise, k_scale = jax.random.split(key)

    correct = params.q_ratio_style == "correct"
    if params.use_softplus_transform:
        if not params.sample_scale:
            # default path: noise-only softplus walk + inverse-gamma prior
            # (noise_scale_proposals.py:134-156)
            new_noise = _propose_softplus(k_noise, noise, NOISE_STEP)
            log_q = (
                _softplus_log_jac_ratio(noise, new_noise)
                if correct
                else -_softplus_log_q_sq(noise, new_noise, NOISE_STEP**2)
            )
            log_prior = inverse_gamma_logpdf(
                new_noise, params.gamma_prior_shape, params.gamma_prior_rate
            ) - inverse_gamma_logpdf(
                noise, params.gamma_prior_shape, params.gamma_prior_rate
            )
            return (new_noise, scale), log_q + log_prior

        # joint softplus walk + half-normal priors
        # (noise_scale_proposals.py:100-131; the reference's joint path
        # additionally flips the ratio's overall sign vs its noise-only
        # path — both spurious-kernel variants are reproduced only under
        # q_ratio_style="reference")
        new_noise = _propose_softplus(k_noise, noise, NOISE_STEP)
        new_scale = _propose_softplus(k_scale, scale, SCALE_STEP)
        if correct:
            log_q = _softplus_log_jac_ratio(noise, new_noise) + (
                _softplus_log_jac_ratio(scale, new_scale)
            )
        else:
            log_q = _softplus_log_q_sq(noise, new_noise, NOISE_STEP**2) + (
                _softplus_log_q_sq(scale, new_scale, SCALE_STEP**2)
            )
        log_prior = (
            half_normal_logpdf(new_noise, 1.0)
            + half_normal_logpdf(new_scale, 5.0)
            - half_normal_logpdf(noise, 1.0)
            - half_normal_logpdf(scale, 5.0)
        )
        return (new_noise, new_scale), log_q + log_prior

    if not params.sample_scale:
        raise NotImplementedError(
            "You must sample the scale parameter in the log space"
        )

    # log-space walk + half-normal priors (noise_scale_proposals.py:70-97)
    new_noise = _propose_log(k_noise, noise, NOISE_STEP)
    new_scale = _propose_log(k_scale, scale, SCALE_STEP)
    log_q = -jnp.log(noise) - jnp.log(scale) + jnp.log(new_noise) + jnp.log(new_scale)
    log_prior = (
        half_normal_logpdf(new_noise, 1.0)
        + half_normal_logpdf(new_scale, 5.0)
        - half_normal_logpdf(noise, 1.0)
        - half_normal_logpdf(scale, 5.0)
    )
    return (new_noise, new_scale), log_q + log_prior
