"""Static sampler configuration.

Parity: the reference's ``BARKTrainParamsNumba`` jitclass
(src/bark/fitting/bark_sampler.py:48-92) and the pydantic surrogate defaults
(src/bofire_mixed/data_models/surrogates/bark.py:15-40). Fields are Python
scalars and the dataclass is hashable, so it is passed as a static jit
argument — changing a parameter triggers a (cached) recompile, which matches
how these are used (fixed per study).

Fixed-shape additions: ``node_limit`` and ``max_depth`` bound the static
shapes (the reference caps trees at 100 nodes, src/bark/forest.py:114-117;
we also cap depth so leaf routing has an exact static trip count — the
depth prior alpha(1+d)^-beta makes mass beyond depth 16 negligible).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from bark_jax.forest import DEFAULT_MAX_DEPTH, DEFAULT_NODE_LIMIT


@dataclass(frozen=True)
class SamplerParams:
    # MCMC run parameters (src/bofire_mixed/data_models/surrogates/bark.py:18-21)
    warmup_steps: int = 50
    num_samples: int = 5
    steps_per_sample: int = 10
    num_chains: int = 1

    # node depth prior (…/bark.py:24-26)
    alpha: float = 0.95
    beta: float = 2.0
    num_trees: int = 50

    # noise and scale proposal parameters (…/bark.py:28-34)
    use_softplus_transform: bool = True
    sample_scale: bool = False
    gamma_prior_shape: float = 1.5
    gamma_prior_rate: float = 5.0

    # transition type probabilities (…/bark.py:36-38)
    grow_prune_weight: float = 0.5
    change_weight: float = 1.0

    # Hastings-ratio style for the softplus noise/scale walk:
    #   "correct" (default) — Jacobian-only q-ratio. The Gaussian kernel in
    #     inverse-softplus space is symmetric, so only the change-of-
    #     variables term log|dt/dx| survives the ratio; a prior-only MH
    #     chain under this form reproduces the analytic inverse-gamma prior
    #     on every quantile (results/diagnostics/qratio_bug.md).
    #   "reference" — the reference's formula
    #     (src/bark/fitting/noise_scale_proposals.py:138-149), which keeps a
    #     spurious (delta t)^2/step^2 kernel term in the ratio. That term
    #     suppresses large moves asymmetrically relative to the target and
    #     provably biases the stationary law (measured: noise-prior mean
    #     0.194 vs analytic 0.400; q90 0.357 vs 0.684). Kept ONLY so the
    #     parity harness can compare transition kernels like-for-like.
    q_ratio_style: str = "correct"

    # fixed-shape caps (see module docstring)
    node_limit: int = DEFAULT_NODE_LIMIT
    max_depth: int = DEFAULT_MAX_DEPTH

    # kernel-update backend:
    #   "rank1" (default) — minimal-rank Sherman-Morrison inverse updates
    #     (every move's kernel delta is exactly rank-2; no per-move
    #     factorization; once-per-step exact refresh bounds f32 drift);
    #   "chol" — exact-delta K + Cholesky refactor per move (drift-free by
    #     construction, the conservative oracle);
    #   "woodbury" — the reference's rank-L incremental inverse maintenance
    #     (src/bark/fitting/quick_inverse.py:12-38).
    # All three produce identical trajectories under identical keys (tested).
    kernel_backend: str = "rank1"

    # node-subspace evaluation strategy for proposals (bit-exact pair):
    #   "walk" (default) — recompute the chosen node's subspace by the
    #     fixed-depth parent-chain walk inside the *hoisted, parallel*
    #     proposal batch. No (m, node_limit, D, 2) carry at all.
    #   "carry" — maintain per-node subspaces incrementally across moves
    #     (O(1) child-row updates). Wins when the walk sat on the
    #     sequential move scan; after the proposal hoist the carry's
    #     scan/merge HBM traffic costs more than the parallel walk.
    subspace_mode: str = "walk"

    # lowering style for the hot proposal batch (trajectory-identical). The
    # default and the ranking below come from full-bench A/Bs on the
    # accelerator the sampler was first tuned on (64 chains, N=50, m=50),
    # where small dynamic scatters carried a large fixed cost; none of the
    # four has been measured on the H100 yet:
    #   "walk_select" (default, first) — the subspace walk's per-trip bound
    #     update is a (D,) one-hot select and its reads are whole packed
    #     rows; no scatter in the walk.
    #   "scatter" (last but one) — dynamic-slice reads + scatter edits
    #     everywhere (the natural XLA lowering; kept as the reference point).
    #   "select" (close second) — additionally converts per-feature reads
    #     and the structural tree edits to one-hot selects.
    #   "doubling" (last) — walk replaced by pointer doubling +
    #     order-independent parallel bound reduction (log2(max_depth)
    #     sequential steps).
    hot_style: str = "walk_select"

    # rank1 backend: lowering of the once-per-step exact refresh.
    #   "auto" (default) — resolve by padded N at trace time
    #     (sampler._resolve_styles): "leaf" once N >= 256, "onesolve"
    #     below. The threshold was chosen by full-bench A/Bs on the
    #     accelerator the sampler was first tuned on (leaf won from N=384
    #     up and tied at 256; the tie resolves to leaf because it removes
    #     the tier's explicit K^-1, the inaccurate object at low noise) and
    #     has not yet been measured on the H100. onesolve's factor-based
    #     branch MLLs are the f64-accurate form, where the explicit-inverse
    #     quad lost ~58 nats at low noise (results/ab_r4/leaf_numerics.md).
    #   "pair" — two chol_inv_logdet calls (cur/new); the N-RHS triangular
    #     solve inside each is a serial substitution, twice per step. Its
    #     branch MLLs ride the explicit inverse — inaccurate at (large N,
    #     small noise); prefer onesolve there (leaf_numerics.md).
    #   "batched" — one (2, N, N) batched factorize+invert.
    #   "onesolve" — both MLLs from one batched Cholesky + single-RHS
    #     solves; the N-RHS inverse solve runs once on the selected
    #     branch's factor. MLL via ||L^-1 y||^2 (same math; last-ulp
    #     association differs from the inverse-based form).
    #   "factor" — the inverse-free (N, N) factor carry; lost narrowly to
    #     "pair" and "leaf" in the first tuning round's A/Bs; kept as the
    #     structural stepping stone the leaf refresh builds on and for its
    #     tests.
    #   "leaf" — N-free refresh in compact leaf-indicator space (see the
    #     leaf_budget notes below); requires the coeff scan.
    refresh_style: str = "auto"

    # rank1 move-scan carry: "plain" keeps (K_inv, v_y) separate; "aug"
    # carries the augmented [K_inv | v_y] so one fused (N,2)@(2,N+1)
    # matmul updates both (measured slightly worse in the first tuning
    # round: XLA already overlaps the v_y matvec; the concat adds work).
    # "lowrank" never writes K_inv in the scan at all: the correction is
    # accumulated as low-rank (P, Q) factors against the frozen start-of-
    # step K0^-1 (the refresh discards the scan's K_inv anyway), and the
    # base products K0^-1 W_j for ALL m moves are one hoisted matmul, so
    # no move touches an (N,N) operand; shedding that traffic only pays
    # once N^2 dominates the latency-bound scan. Same math up to float
    # association (accepts match in f64, tested; not bit-identical in
    # f32). "auto" (default) resolves by the padded N at trace time
    # (sampler._resolve_styles): coeff at N >= 1024, lowrank at
    # 256-1023, plain below; forced to coeff whenever the refresh style is
    # factor/leaf. The tiers were chosen by A/Bs on the accelerator the
    # sampler was first tuned on and have not yet been measured on the
    # H100. The refresh auto resolves to leaf at N >= 256, so the dense
    # lowrank/coeff tiers are reachable only via an explicit refresh pin.
    scan_style: str = "auto"

    # refresh_style="leaf" (requires scan_style="coeff") replaces the
    # once-per-step exact (N, N) refresh with an N-FREE factored refresh:
    # K = nu*I + (scale/m) Z Z^T with Z the (N, R) compact leaf-indicator
    # matrix (R = leaf_budget slots packed per-tree), so both MH branches'
    # logdet/quadratic come from one batched (2, R, R) Cholesky of
    # A = (nu/gamma) I + Z^T Z (matrix-determinant lemma + Woodbury —
    # exactly the repo's tested oracles, ops/linalg.py:60-88), and the
    # coeff scan's hoisted products come from one (R, 2m+1) triangular
    # solve against the carried factor of A instead of an N-RHS solve.
    # The (N, N) gram is never built. Exact (same math up to float
    # association) PROVIDED the forest's total leaf count stays <= R; the
    # move scan enforces that by MH-rejecting grow moves at capacity — a
    # principled truncation of the tree prior (the reference truncates the
    # same way per-tree at node_limit, src/bark/fitting/tree_proposals.py:58)
    # that is statistically invisible at the default budget (measured
    # un-truncated posterior totals at the bench config: mean 130-155,
    # max 171 across N=200..1024 — results/ab_r4/leaf_totals.json).
    #
    # leaf_budget: total compact leaf slots R. 0 (auto) resolves by the
    # padded N (sampler._leaf_budget): 5 leaves/tree up to N=2048, 7.5 to
    # 8192, 10 beyond (256/384/512 at m=50) — tiers chosen so R stays >=
    # ~5 sigma above the MEASURED un-truncated posterior totals, which
    # grow with N (mean/max 130/143 at N=200 ... 225/262 at N=4096,
    # results/ab_r4/leaf_totals.json). Budgets below the realized totals
    # make the capacity guard truncate the posterior for speed — don't.
    leaf_budget: int = 0

    # rank1 move-scan unroll factor (lax.scan ``unroll``). The scan is
    # latency-bound on per-move op count, so letting XLA fuse/pipeline
    # consecutive iterations can shave fixed per-iteration overhead at the
    # cost of compile time and code size. Full-bench A/B decides per regime
    # (see scan_style notes for the measurement discipline).
    scan_unroll: int = 1

    # Cholesky for the once-per-step exact refresh:
    #   -1 ("auto", default) — resolves to 0 at every N: the blocked form
    #     lost the full-bench A/B in the first tuning round (its per-panel
    #     memory round-trips cost more than the column-loop latency they
    #     save at refresh batch 2*chains); not yet measured on the H100.
    #    0 — always XLA's jnp.linalg.cholesky.
    #   >0 — blocked right-looking factorization
    #     (ops/linalg.blocked_cholesky) with this panel size (must divide
    #     the padded N, else falls back to XLA). Opt-in only; re-promote
    #     to auto only with a committed full-bench A/B win.
    chol_block: int = -1

    # one-hot operand dtype for the refresh's Gram rebuild: "bf16" halves
    # the matmul's input traffic and uses the faster bf16 path with
    # BIT-IDENTICAL counts (0/1 operands exact in bf16, f32 accumulation).
    # Only material once the gram matmul is compute-bound (large padded N);
    # full-bench A/B decides the auto threshold.
    gram_dtype: str = "f32"

    _ALLOWED_MODES = {
        "kernel_backend": ("rank1", "chol", "woodbury"),
        "subspace_mode": ("walk", "carry"),
        "hot_style": ("walk_select", "scatter", "select", "doubling"),
        "refresh_style": (
            "auto", "pair", "batched", "onesolve", "factor", "leaf"
        ),
        "scan_style": ("plain", "aug", "lowrank", "coeff", "auto"),
        "gram_dtype": ("f32", "bf16"),
        "q_ratio_style": ("correct", "reference"),
    }

    def __post_init__(self):
        # A typo'd mode would otherwise fall through else-branches to the
        # slow lowering silently (a perf regression, not an error).
        for name, allowed in self._ALLOWED_MODES.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"SamplerParams.{name}={value!r}: must be one of {allowed}"
                )
        if self.refresh_style in ("factor", "leaf") and self.scan_style not in (
            "coeff",
            "auto",
        ):
            # the factor/leaf carries store a Cholesky factor where other
            # scans expect K^-1; only the coefficient-space scan consumes
            # the kernel exclusively through symmetric products, which is
            # what makes the inverse-free carries possible ("auto" resolves
            # to coeff under these refreshes, sampler._resolve_styles).
            raise ValueError(
                f'refresh_style="{self.refresh_style}" requires '
                'scan_style="coeff" (or "auto")'
            )
        if not (isinstance(self.leaf_budget, int) and self.leaf_budget >= 0):
            raise ValueError(
                f"SamplerParams.leaf_budget={self.leaf_budget!r}: must be 0 "
                "(auto) or a positive slot count"
            )
        if not (isinstance(self.chol_block, int) and self.chol_block >= -1):
            raise ValueError(
                f"SamplerParams.chol_block={self.chol_block!r}: must be -1 "
                "(auto), 0 (XLA), or a positive panel size"
            )
        if not (isinstance(self.scan_unroll, int) and self.scan_unroll >= 1):
            raise ValueError(
                f"SamplerParams.scan_unroll={self.scan_unroll!r}: must be a "
                "positive int"
            )

    @property
    def proposal_weights(self) -> tuple[float, float, float]:
        """Normalized (grow, prune, change) probabilities.

        Parity: the commented-out dataclass property in
        src/bark/fitting/bark_sampler.py:41-46.
        """
        p = (self.grow_prune_weight, self.grow_prune_weight, self.change_weight)
        s = sum(p)
        return (p[0] / s, p[1] / s, p[2] / s)

    def with_(self, **kwargs) -> "SamplerParams":
        return replace(self, **kwargs)
