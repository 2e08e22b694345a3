"""The softplus noise-proposal Hastings ratio samples the right law.

Round-5 finding (results/diagnostics/qratio_bug.md): the reference's
softplus q-ratio keeps a spurious symmetric kernel term that breaks
detailed balance and halves the noise prior's upper tail. The shipped
default is the corrected Jacobian-only ratio; a prior-only MH chain
under it must reproduce the analytic inverse-gamma prior, and the
"reference" compatibility style must remain detectably biased (so the
fix cannot be silently lost).
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats as stats

from bark_jax.fitting.noise_scale import get_noise_scale_proposal
from bark_jax.fitting.params import SamplerParams

CHAINS, STEPS, BURN = 32, 4000, 1000


def _prior_chain(style):
    params = SamplerParams(q_ratio_style=style)

    def one_step(noise, k):
        k_prop, k_acc = jax.random.split(k)
        (new_noise, _), log_alpha = get_noise_scale_proposal(
            k_prop, noise, jnp.float32(1.0), params
        )
        u = jax.random.uniform(k_acc, dtype=jnp.float32)
        noise = jnp.where(
            jnp.log(u) <= jnp.minimum(log_alpha, 0.0), new_noise, noise
        )
        return noise, noise

    def one_chain(k):
        _, trace = jax.lax.scan(
            one_step, jnp.float32(1.0), jax.random.split(k, STEPS)
        )
        return trace

    traces = jax.jit(jax.vmap(one_chain))(
        jax.random.split(jax.random.key(0), CHAINS)
    )
    return np.asarray(traces, np.float64)[:, BURN:]


def test_default_ratio_samples_the_prior():
    params = SamplerParams()
    post = _prior_chain("correct")
    dist = stats.invgamma(
        params.gamma_prior_shape, scale=1.0 / params.gamma_prior_rate
    )
    # median and q10 are tail-robust; the heavy InvGamma(1.5) tail makes
    # the mean itself a noisy statistic at this budget
    assert abs(np.quantile(post, 0.5) - dist.ppf(0.5)) < 0.02
    assert abs(np.quantile(post, 0.1) - dist.ppf(0.1)) < 0.01
    assert abs(np.quantile(post, 0.9) - dist.ppf(0.9)) < 0.12


def test_reference_ratio_stays_biased():
    """Contrast guard: if this starts PASSING the prior check, the
    compatibility style has drifted and parity replays are no longer
    like-for-like."""
    params = SamplerParams()
    post = _prior_chain("reference")
    dist = stats.invgamma(
        params.gamma_prior_shape, scale=1.0 / params.gamma_prior_rate
    )
    # the documented signature: upper tail roughly halved
    assert np.quantile(post, 0.9) < 0.6 * dist.ppf(0.9)


def test_styles_share_the_proposal_draw():
    """Only the ratio differs — the proposed value itself is identical."""
    k = jax.random.key(7)
    (n_a, _), _ = get_noise_scale_proposal(
        k, jnp.float32(0.3), jnp.float32(1.0),
        SamplerParams(q_ratio_style="correct"),
    )
    (n_b, _), _ = get_noise_scale_proposal(
        k, jnp.float32(0.3), jnp.float32(1.0),
        SamplerParams(q_ratio_style="reference"),
    )
    assert float(n_a) == float(n_b)
