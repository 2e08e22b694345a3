"""Matrix-free large-N GP algebra: CG posteriors over the factored kernel.

The dense paths (ops/linalg.py, models/gp.py) materialize the N x N
agreement kernel and Cholesky-factorize it — O(N^2) memory, O(N^3) work,
single-chip. This module is the large-N alternative SURVEY §5 calls for
(the reference has nothing: its dense inverses are
src/bark/tree_kernels/tree_gps.py:102, src/bark/fitting/bark_sampler.py:160):

The agreement kernel FACTORIZES. With Z the (N, m*node_limit) stacked
leaf one-hot matrix scaled by 1/sqrt(m),

    K = scale * Z Z^T,     (K + (noise + jitter) I) v
                           = scale * Z (Z^T v) + (noise + jitter) v

so a kernel matvec costs O(N * m * node_limit) time and O(N * m * L)
memory — never O(N^2) — and both are plain matmuls. Conjugate
gradients with a Jacobi preconditioner then give posterior means and
variances matrix-free; since K is rank <= m * (leaves per tree) plus a
diagonal, CG converges in at most rank+1 iterations in exact arithmetic
(far fewer in practice).

Sharding: every array in the solve has N only on its leading axis, so
sharding rows over a mesh axis data-parallelizes the whole solve — XLA
inserts the psum for Z^T v and the CG dot products automatically under
jit (`shard_posterior_inputs` annotates; tested identical to the
single-device result on the 8-device virtual mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bark_jax.forest import leaf_onehot
from bark_jax.ops.linalg import JITTER


def leaf_features(
    leaves: jax.Array, node_limit: int, mask: jax.Array | None = None
) -> jax.Array:
    """(N, m*node_limit) scaled one-hot features with K = scale * Z Z^T.

    Masked (padded) rows are zeroed: they get zero kernel rows/columns and
    an isolated (noise+jitter) diagonal, exactly like the dense path
    (forest.gram_from_leaves mask semantics), so they drop out of the
    posterior.
    """
    n, m = leaves.shape
    z = leaf_onehot(leaves, node_limit).reshape(n, m * node_limit)
    z = z / jnp.sqrt(jnp.float32(m))
    if mask is not None:
        z = z * mask[:, None].astype(z.dtype)
    return z


def kernel_matvec(Z: jax.Array, noise, scale, v: jax.Array) -> jax.Array:
    """(K + (noise + jitter) I) v without materializing K. v is (N,)."""
    return scale * (Z @ (Z.T @ v)) + (JITTER + noise) * v


def _jacobi_diag(Z: jax.Array, noise, scale) -> jax.Array:
    """diag(K) + noise + jitter (= scale + noise + jitter on real rows)."""
    return scale * jnp.sum(Z * Z, axis=1) + (JITTER + noise)


@functools.partial(jax.jit, static_argnames=("maxiter",))
def cg_solve(
    Z: jax.Array,
    noise: jax.Array,
    scale: jax.Array,
    rhs: jax.Array,
    maxiter: int = 256,
    tol: float = 1e-6,
) -> jax.Array:
    """Solve (K + (noise+jitter) I) x = rhs by preconditioned CG.

    ``rhs`` is (N,) or (N, B); columns are solved as independent vmapped
    CG runs (CG scalars must not mix columns).
    """
    diag = _jacobi_diag(Z, noise, scale)

    def solve_one(b):
        x, _ = jax.scipy.sparse.linalg.cg(
            lambda v: kernel_matvec(Z, noise, scale, v),
            b,
            M=lambda v: v / diag,
            maxiter=maxiter,
            tol=tol,
        )
        return x

    if rhs.ndim == 1:
        return solve_one(rhs)
    return jax.vmap(solve_one, in_axes=1, out_axes=1)(rhs)


@functools.partial(jax.jit, static_argnames=("node_limit", "maxiter"))
def cg_posterior(
    train_leaves: jax.Array,
    cand_leaves: jax.Array,
    y: jax.Array,
    noise: jax.Array,
    scale: jax.Array,
    node_limit: int,
    mask: jax.Array | None = None,
    maxiter: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """Posterior mean/variance at candidates, matrix-free.

    Same semantics as the dense ``gp_posterior`` used by
    ``models.gp.forest_predict`` (prior variance = scale at every
    candidate, diag(gram) = 1):

        mu  = K_xX (K + nu I)^-1 y
        var = scale - diag(K_xX (K + nu I)^-1 K_Xx)

    but with every product factored through Z — nothing N x N is ever
    built, for train sets far past the dense path's memory wall.
    """
    Z = leaf_features(train_leaves, node_limit, mask)
    Zc = leaf_features(cand_leaves, node_limit)

    alpha = cg_solve(Z, noise, scale, y, maxiter=maxiter)
    mu = scale * (Zc @ (Z.T @ alpha))

    # K_Xx columns as (N, B): scale * Z (Zc^T) per candidate
    K_Xx = scale * (Z @ Zc.T)  # (N, B) — O(N*B), not O(N^2)
    W = cg_solve(Z, noise, scale, K_Xx, maxiter=maxiter)
    var = scale - jnp.sum(K_Xx * W, axis=0)
    return mu, jnp.maximum(var, 1e-12)


def shard_posterior_inputs(mesh, *arrays):
    """Place row-major arrays with their leading axis sharded over ``mesh``.

    The mesh must have a single axis (any name). Row counts must divide the
    device count. Returns the arrays device_put with NamedSharding; running
    ``cg_posterior`` on them data-parallelizes the solve (XLA inserts the
    collectives for Z^T v and the CG reductions).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]

    def place(a):
        spec = P(axis, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return tuple(place(a) for a in arrays)
