"""Prior / proposal diagnostics study.

The reference ships this as notebook-tier material: a lognormal-proposal
visualization (examples/notebooks/priors_and_proposals.ipynb), and a
standalone MH sanity chain for the noise proposal
(examples/notebooks/noise_proposal_test.py:26-49 — a prior-targeting
random-walk whose stationary law must reproduce the prior). Here both
become a scripted, assertable study over the repo's OWN proposal
machinery (fitting/noise_scale.py), not a reimplementation:

  1. transition-density check: the log-space random walk
     ``exp(log x + s N(0,1))`` is lognormal(s, scale=x) — empirical
     histogram vs the analytic density;
  2. prior-only MH chain: run ``get_noise_scale_proposal`` with a ZERO
     likelihood (the MH ratio is exactly the proposal's q + prior-ratio
     term), vmapped over chains and scanned over steps; the chain's
     stationary distribution must match the analytic inverse-gamma prior
     (default path) — empirical vs analytic mean and quantiles;
  3. prior density plots: inverse-gamma noise prior and half-normal
     scale prior (the reference's notebook cell 3).

Writes figures + a JSON summary under results/diagnostics/.

Usage::

    python examples/priors_and_proposals.py [--steps 4000] [--chains 64]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

OUT_DIR = (
    pathlib.Path(__file__).resolve().parent.parent / "results" / "diagnostics"
)


def lognormal_proposal_check(key, x0=1.0, step=0.1, n=10_000):
    """Empirical _propose_log draws vs the analytic lognormal density."""
    from bark_jax.fitting.noise_scale import _propose_log

    keys = jax.random.split(key, n)
    draws = jax.vmap(
        lambda k: _propose_log(k, jnp.float32(x0), jnp.float32(step))
    )(keys)
    draws = np.asarray(draws, np.float64)
    # analytic: log draws ~ N(log x0, step^2)
    z = (np.log(draws) - np.log(x0)) / step
    return {
        "proposal_log_mean_z": float(z.mean() * np.sqrt(n)),
        "proposal_log_std": float(z.std(ddof=1)),
        "draws": draws,
    }


def prior_only_mh_chain(key, params, steps, chains, init=1.0):
    """MH on the noise prior alone through the repo's real proposal.

    With no data, the BARK accept ratio reduces to the proposal's
    log(q-ratio + prior-ratio) term — exactly what
    ``get_noise_scale_proposal`` returns. The chain must therefore sample
    the prior; any bug in the Jacobian/q-ratio arithmetic shows up as a
    biased stationary law (this is the reference's
    noise_proposal_test.py:26-49 in assertable form).
    """
    from bark_jax.fitting.noise_scale import get_noise_scale_proposal

    def one_step(noise, k):
        k_prop, k_acc = jax.random.split(k)
        (new_noise, _), log_alpha = get_noise_scale_proposal(
            k_prop, noise, jnp.float32(1.0), params
        )
        u = jax.random.uniform(k_acc, dtype=jnp.float32)
        accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)
        noise = jnp.where(accept, new_noise, noise)
        return noise, (noise, accept)

    def one_chain(k):
        keys = jax.random.split(k, steps)
        _, (trace, accepts) = jax.lax.scan(
            one_step, jnp.float32(init), keys
        )
        return trace, accepts

    traces, accepts = jax.jit(jax.vmap(one_chain))(
        jax.random.split(key, chains)
    )
    return np.asarray(traces, np.float64), np.asarray(accepts)


def inverse_gamma_moments(shape, rate, q=(0.1, 0.5, 0.9)):
    """Analytic mean + quantiles for the repo's InvGamma(shape, scale=1/rate)
    parameterization (fitting/noise_scale.py:35-40)."""
    import scipy.stats as stats

    dist = stats.invgamma(shape, scale=1.0 / rate)
    return float(dist.mean()), [float(dist.ppf(p)) for p in q]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--burn-frac", type=float, default=0.25)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument(
        "--platform", default="cpu",
        help="jax platform (default cpu: this study is scalar-chain work)",
    )
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from bark_jax.fitting.params import SamplerParams

    key = jax.random.key(0)
    k_prop, k_mh = jax.random.split(key)

    prop = lognormal_proposal_check(k_prop)

    defaults = SamplerParams()
    mean_an, q_an = inverse_gamma_moments(
        defaults.gamma_prior_shape, defaults.gamma_prior_rate
    )
    burn = int(args.steps * args.burn_frac)

    def mh_summary(style):
        params = SamplerParams(q_ratio_style=style)
        traces, accepts = prior_only_mh_chain(
            k_mh, params, args.steps, args.chains
        )
        post = traces[:, burn:]
        # per-chain means are the independent units for the z-score
        chain_means = post.mean(axis=1)
        se = chain_means.std(ddof=1) / np.sqrt(len(chain_means))
        return post, {
            "mh_accept_rate": float(accepts[:, burn:].mean()),
            "noise_prior_mean_empirical": float(chain_means.mean()),
            "noise_prior_mean_z": float(
                abs(chain_means.mean() - mean_an) / max(se, 1e-12)
            ),
            "noise_prior_quantiles_empirical": [
                float(np.quantile(post, p)) for p in (0.1, 0.5, 0.9)
            ],
        }

    # the shipped default ("correct") must reproduce the analytic prior;
    # the reference's q-ratio is kept for contrast — its bias is the
    # motivating finding (results/diagnostics/qratio_bug.md)
    post, correct_stats = mh_summary("correct")
    _, reference_stats = mh_summary("reference")

    summary = {
        "config": {
            "steps": args.steps, "chains": args.chains, "burn": burn,
            "prior": f"InvGamma(shape={defaults.gamma_prior_shape}, "
                     f"scale=1/{defaults.gamma_prior_rate})",
        },
        "proposal_lognormal": {
            k: v for k, v in prop.items() if k != "draws"
        },
        "noise_prior_mean_analytic": mean_an,
        "noise_prior_quantiles_analytic": q_an,
        "default_correct_ratio": correct_stats,
        "reference_ratio_for_contrast": reference_stats,
    }
    print(json.dumps(summary), flush=True)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = pathlib.Path(args.out) if args.out else (
        OUT_DIR / "priors_and_proposals.json"
    )
    out.write_text(json.dumps(summary, indent=1))

    if not args.no_plots:
        import scipy.stats as stats

        from bark_jax.fitting.noise_scale import (
            half_normal_logpdf,
            inverse_gamma_logpdf,
        )
        from bark_jax.utils.plots import plt, save_fig

        # 1. proposal histogram vs lognormal density
        fig, ax = plt.subplots(figsize=(5, 3.2))
        ax.hist(prop["draws"], bins=40, density=True, alpha=0.6)
        t = np.linspace(1e-3, prop["draws"].max(), 400)
        ax.plot(t, stats.lognorm(s=0.1, scale=1.0).pdf(t))
        ax.set_title("log-space proposal vs lognormal density")
        save_fig(fig, OUT_DIR / "proposal_lognormal.png")

        # 2. prior densities (reference notebook cell 3)
        fig, ax = plt.subplots(figsize=(5, 3.2))
        t = np.linspace(1e-3, 3.0, 400)
        ax.plot(t, np.exp(np.asarray(inverse_gamma_logpdf(
            jnp.asarray(t), defaults.gamma_prior_shape,
            defaults.gamma_prior_rate,
        ))), label="noise prior (InvGamma)")
        ax.plot(t, np.exp(np.asarray(half_normal_logpdf(
            jnp.asarray(t), 5.0,
        ))), label="scale prior (HalfNormal)")
        ax.legend()
        save_fig(fig, OUT_DIR / "prior_densities.png")

        # 3. MH chain histogram vs analytic prior
        fig, ax = plt.subplots(figsize=(5, 3.2))
        ax.hist(post.reshape(-1), bins=60, density=True, alpha=0.6,
                range=(0.0, 3.0))
        ax.plot(t, stats.invgamma(
            defaults.gamma_prior_shape, scale=1.0 / defaults.gamma_prior_rate
        ).pdf(t), label="analytic prior")
        ax.legend()
        ax.set_title("prior-only MH chain vs analytic inverse-gamma")
        save_fig(fig, OUT_DIR / "noise_mh_vs_prior.png")

    return summary


if __name__ == "__main__":
    main()
