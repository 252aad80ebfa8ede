"""VGICP-style registration: the framework's north-star kernel.

Functional re-design of the reference's NanoGICP + LsqRegistration stack
(``include/nano_gicp/impl/nano_gicp_impl.hpp``,
``include/nano_gicp/impl/lsq_registration_impl.hpp``):

- per-iteration 1-NN correspondences -> tiled-matmul sweep (:mod:`.knn`),
- per-point Mahalanobis ``(C_B + R C_A R^T)^-1``            -> batched
  closed-form 3x3 inverse (elementwise),
- per-thread OpenMP H/b partial sums (nano_gicp_impl.hpp:284-339)
  -> one ``(3N, 6)^T @ (3N, 6)`` matmul,
- the Levenberg-Marquardt outer loop (lsq_registration_impl.hpp:96-232)
  -> ``lax.while_loop`` with masked convergence flags.

Everything is a pure function of ``(clouds, covariances, guess)``; a batch
of registrations is just ``vmap(align)`` and shards across a device mesh
with no code change. Scalars accumulate in f32 (the reference uses f64 —
see tests/test_gicp.py for the accuracy budget this meets).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamic_direct_lidar_odometry.core import se3
from dynamic_direct_lidar_odometry.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry.ops import knn as knn_ops
from dynamic_direct_lidar_odometry.ops import nn_pallas


class GICPSettings(NamedTuple):
    """Static (compile-time) optimizer settings.

    Defaults follow LsqRegistration's ctor (lsq_registration_impl.hpp:53-61)
    with the YAML overrides applied the way OdomNode does (odom.cc:92-106):
    ``maxIterations`` and ``transformationEpsilon`` map onto the PCL members
    the LM loop actually reads; ``rotation_epsilon`` has no YAML knob.
    """

    max_correspondence_distance: float = 1.0
    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9
    optimizer: str = "lm"  # "lm" | "gn"
    # run one extra correspondence pass at the final pose to export
    # per-point NN residuals (getResiduals, odom.cc:792-793 — the
    # reference only does this for the S2M result feeding the residual
    # image; S2S skips it and saves a full NN sweep)
    compute_residuals: bool = True
    # record the pose after every outer LM/GN iteration into
    # GICPResult.pose_trace — for convergence debugging and the
    # reference-parity tests (tests/test_reference_parity.py), which
    # compare the trajectory against a float64 oracle of
    # lsq_registration_impl.hpp:96-126 iteration by iteration
    record_trace: bool = False
    # correspondence-search backend: "exact" (the XLA sweep, knn.nn1) or
    # "sparse" (exact within max_correspondence_distance: the block-sparse
    # Pallas kernel on the GPU, the exact sweep on every other platform,
    # knn.nn1_within). Compile-time static; the odometry layer maps the
    # DDLO_NN_IMPL env var onto this once.
    nn_impl: str = "exact"


_EMPTY_TRACE = np.zeros((0, 4, 4), np.float32)


class GICPResult(NamedTuple):
    T: jnp.ndarray  # (4, 4) final transformation
    converged: jnp.ndarray  # () bool
    iterations: jnp.ndarray  # () int32
    final_error: jnp.ndarray  # () f32 sum of Mahalanobis errors
    final_hessian: jnp.ndarray  # (6, 6)
    num_inliers: jnp.ndarray  # () int32 correspondences inside max dist
    residuals: jnp.ndarray  # (N,) NN distance per source point at final T
    correspondences: jnp.ndarray  # (N,) int32 target index (-1 if invalid)
    # (max_iterations, 4, 4) pose after each outer iteration (rows past
    # `iterations` repeat the final pose); (0, 4, 4) unless record_trace.
    # NumPy default: a jnp default would initialize the backend at import
    # (breaking jax.distributed.initialize ordering).
    pose_trace: jnp.ndarray = _EMPTY_TRACE


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form (adjugate) 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A, D, G], axis=-1),
            jnp.stack([B, E, H], axis=-1),
            jnp.stack([C, F, I], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def solve6_ldlt(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve the symmetric 6x6 normal equations by unrolled LDLT — the
    decomposition the reference uses (lsq_registration_impl.hpp:190,
    Eigen::LDLT). ``jnp.linalg.solve`` lowers a 6x6 to a generic LU
    whose fixed overhead dwarfs the ~100 flops actually needed;
    this unrolled form is pure fused scalar math inside the LM loop.
    """
    L = [[None] * 6 for _ in range(6)]
    D = [None] * 6
    for j in range(6):
        d = A[j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k] * D[k]
        # singular H is guarded upstream (degenerate flag); keep the
        # pivot finite so a pathological iterate can't emit inf/NaN
        D[j] = jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
        for i in range(j + 1, 6):
            v = A[i, j]
            for k in range(j):
                v = v - L[i][k] * L[j][k] * D[k]
            L[i][j] = v / D[j]
    # forward solve L y = b
    y = [None] * 6
    for i in range(6):
        v = b[i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y[i] = v
    # diagonal + back solve L^T x = y / D
    x = [None] * 6
    for i in reversed(range(6)):
        v = y[i] / D[i]
        for k in range(i + 1, 6):
            v = v - L[k][i] * x[k]
        x[i] = v
    return jnp.stack(x)


def _linearize(
    T: jnp.ndarray,
    src_pts: jnp.ndarray,
    src_mask: jnp.ndarray,
    src_covs: jnp.ndarray,
    tgt_pts: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    tgt_covs: jnp.ndarray,
    max_corr_dist: float,
    nn_impl: str = "exact",
    prune_dilation: float = 1.0,
    sparse_prep=None,
    tgt_feat=None,
):
    """One GICP linearization at pose T.

    Fuses ``update_correspondences`` (nano_gicp_impl.hpp:235-275) and
    ``linearize`` (:278-342): NN correspondences, Mahalanobis weights
    M = (C_B + R C_A R^T)^-1, error y0 = sum e^T M e, and the 6x6/6x1
    Gauss-Newton normal equations H, b with J = [skew(T a) | -I].

    ``nn_impl`` picks the correspondence backend (GICPSettings.nn_impl).
    """
    # NOTE all matmuls/einsums here run at Precision.HIGHEST: an unpinned
    # f32 matmul may run as TF32 (~1e-3 relative) on the GPU, which both
    # floors the GICP error (killing convergence, the reference converges
    # on trans_eps=5e-4, lsq_registration_impl.hpp:135) and corrupts the
    # cancellation-heavy b vector near the optimum.
    hp = jax.lax.Precision.HIGHEST
    R = T[:3, :3]
    src_t = se3.transform_points(T, src_pts)
    src_t_q = jnp.where(src_mask[:, None], src_t, SENTINEL)

    if nn_impl == "sparse":
        # exact for every pair the max_corr_dist gate keeps (distances of
        # gated-out points saturate; only the debug image sees them). The
        # target-side prep is hoisted to align() (sparse_prep).
        idx, sqd = knn_ops.nn1_within(
            src_t_q, tgt_pts, max_corr_dist * prune_dilation, sparse_prep
        )
    else:
        idx, sqd = knn_ops.nn1(src_t_q, tgt_pts)
    # no tgt_mask[idx] gather: invalid targets sit at the SENTINEL, so
    # their squared distance to any real (src-masked) query is ~1e12 and
    # the max_corr_dist gate below always discards them
    valid = src_mask & (sqd < max_corr_dist * max_corr_dist)
    vf = valid.astype(src_pts.dtype)
    # ONE (N, 12) gather for the winner's coordinates + covariance
    # instead of two row gathers. tgt_feat is hoisted to align(); standalone calls build it here.
    if tgt_feat is None:
        N_t = tgt_pts.shape[0]
        tgt_feat = jnp.concatenate(
            [tgt_pts, tgt_covs.reshape(N_t, 9)], axis=1
        )
    feat = tgt_feat[idx]
    B = feat[:, :3]
    cov_B = feat[:, 3:].reshape(-1, 3, 3)
    RCAR = jnp.einsum("ij,njk,lk->nil", R, src_covs, R, precision=hp)
    M = inv3x3(cov_B + RCAR)  # (N, 3, 3) mahalanobis weights

    e = (B - src_t) * vf[:, None]  # (N, 3)

    Me = jnp.einsum("nij,nj->ni", M, e, precision=hp)
    y0 = jnp.sum(e * Me)

    # J = [skew(T a) | -I], rows masked by validity
    S = se3.skew(src_t)  # (N, 3, 3)
    J = jnp.concatenate(
        [S, -jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), S.shape)], axis=-1
    )  # (N, 3, 6)
    J = J * vf[:, None, None]
    MJ = jnp.einsum("nij,njk->nik", M, J, precision=hp)

    N = src_pts.shape[0]
    # one matmul for the full 6x6 reduction (replaces the per-thread
    # OpenMP partials of the reference)
    H = jnp.matmul(J.reshape(N * 3, 6).T, MJ.reshape(N * 3, 6), precision=hp)
    b = jnp.einsum("nij,ni->j", J, Me, precision=hp)

    aux = (idx, valid, M, B, sqd)
    return y0, H, b, aux


def _compute_error(T, src_pts, aux):
    """Re-evaluate sum e^T M e at a candidate pose with the correspondences
    and Mahalanobis weights fixed from the last linearization
    (nano_gicp_impl.hpp:345-371)."""
    idx, valid, M, B, _ = aux
    src_t = se3.transform_points(T, src_pts)
    e = (B - src_t) * valid[:, None].astype(src_pts.dtype)
    Me = jnp.einsum("nij,nj->ni", M, e, precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(e * Me)


def _is_converged(delta: jnp.ndarray, s: GICPSettings) -> jnp.ndarray:
    """Reference convergence test (lsq_registration_impl.hpp:129-139)."""
    Rd = jnp.abs(delta[:3, :3] - jnp.eye(3, dtype=delta.dtype)) / s.rotation_epsilon
    td = jnp.abs(delta[:3, 3]) / s.transformation_epsilon
    return jnp.maximum(jnp.max(Rd), jnp.max(td)) < 1.0


class _LMState(NamedTuple):
    x0: jnp.ndarray
    lm_lambda: jnp.ndarray
    converged: jnp.ndarray
    failed: jnp.ndarray
    it: jnp.ndarray
    y: jnp.ndarray
    H: jnp.ndarray
    trace: jnp.ndarray  # (max_iterations, 4, 4) or (0, 4, 4)


@partial(jax.jit, static_argnames=("settings", "axis_name"))
def align(
    src_pts: jnp.ndarray,
    src_mask: jnp.ndarray,
    src_covs: jnp.ndarray,
    tgt_pts: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    tgt_covs: jnp.ndarray,
    guess: jnp.ndarray,
    settings: GICPSettings = GICPSettings(),
    axis_name: str | None = None,
) -> GICPResult:
    """GICP alignment: find T minimizing sum (b - T a)^T M (b - T a).

    Equivalent of ``NanoGICP::align(output, guess)`` ->
    ``LsqRegistration::computeTransformation`` (lsq_registration_impl.hpp:
    96-126) with the LM stepper (:176-232) or GN stepper (:156-173).

    Args:
      src_pts/tgt_pts: (N,3)/(M,3) f32, invalid rows at SENTINEL.
      src_covs/tgt_covs: (N,3,3)/(M,3,3) PLANE-regularized covariances.
      guess: (4,4) initial transform.
      axis_name: if set, the SOURCE point axis is sharded over this mesh
        axis (``shard_map``): the (y, H, b) normal equations and the error
        re-evaluations are ``psum``-reduced over it — the collective
        equivalent of the reference's per-thread OpenMP H/b partials
        (nano_gicp_impl.hpp:284-339). The target cloud must be replicated
        over the axis; residuals/correspondences come back shard-local.
    """
    s = settings
    tgt_q = jnp.where(tgt_mask[:, None], tgt_pts, SENTINEL)

    # hoist the sparse backend's target-side prep (pad, SoA relayout,
    # chunk boxes) out of the optimization loop: the target never moves
    sparse_prep = None
    if s.nn_impl == "sparse":
        sparse_prep = nn_pallas.prepare_sparse_target(tgt_q)
    # packed winner features for the per-iteration gather (see _linearize)
    tgt_feat = jnp.concatenate(
        [tgt_q, tgt_covs.reshape(tgt_pts.shape[0], 9)], axis=1
    )

    def _allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def _allsum_lin(T, nn_impl, prune_dilation=1.0):
        y0, H, b, aux = _linearize(
            T, src_pts, src_mask, src_covs, tgt_q, tgt_mask, tgt_covs,
            s.max_correspondence_distance, nn_impl, prune_dilation,
            sparse_prep=sparse_prep, tgt_feat=tgt_feat,
        )
        return _allsum(y0), _allsum(H), _allsum(b), aux

    def lin(T):
        return _allsum_lin(T, s.nn_impl)

    def lm_inner(x0, lm_lambda, y0, H, b, aux):
        """One step_lm (lsq_registration_impl.hpp:176-232): inner loop over
        lambda until a step is accepted (rho >= 0), convergence is detected
        on a rejected step, or lm_max_iterations is exhausted."""

        def cond(st):
            j, _, _, done, *_ = st
            return (j < s.lm_max_iterations) & ~done

        def body(st):
            j, lam, nu, done, accepted, conv, x, delta_prev = st
            d = solve6_ldlt(H + lam * jnp.eye(6, dtype=H.dtype), -b)
            delta = se3.se3_exp(d)
            xi = se3.compose(delta, x)
            yi = _allsum(_compute_error(xi, src_pts, aux))
            # dot(d, lam d - b) = d^T (H + lam I) d >= 0; guard the exact-
            # convergence case d = 0, where 0/0 would NaN-poison lam via
            # max(1/3, NaN) and corrupt every later iteration.
            denom = jnp.maximum(jnp.dot(d, lam * d - b), 1e-30)
            rho = (y0 - yi) / denom

            reject = rho < 0
            conv_on_reject = reject & _is_converged(delta, s)
            accept = ~reject

            new_lam = jnp.where(
                accept,
                lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                jnp.where(conv_on_reject, lam, nu * lam),
            )
            new_nu = jnp.where(reject & ~conv_on_reject, 2.0 * nu, nu)
            new_x = jnp.where(accept, xi, x)
            new_done = accept | conv_on_reject
            return (
                j + 1,
                new_lam,
                new_nu,
                new_done,
                accepted | accept,
                conv | conv_on_reject,
                new_x,
                jnp.where(new_done, delta, delta_prev),
            )

        init = (
            jnp.int32(0),
            lm_lambda,
            jnp.float32(2.0),
            jnp.bool_(False),
            jnp.bool_(False),
            jnp.bool_(False),
            x0,
            jnp.eye(4, dtype=x0.dtype),
        )
        j, lam, _, done, accepted, conv_rej, x_new, delta = jax.lax.while_loop(
            cond, body, init
        )
        return x_new, lam, done, accepted, conv_rej, delta

    def outer_cond(st: _LMState):
        return (st.it < s.max_iterations) & ~st.converged & ~st.failed

    def outer_body(st: _LMState) -> _LMState:
        y0, H, b, aux = lin(st.x0)
        lam = jnp.where(
            st.lm_lambda < 0,
            s.lm_init_lambda_factor * jnp.max(jnp.abs(jnp.diagonal(H))),
            st.lm_lambda,
        )
        # Degenerate normal equations (no correspondences inside the gate,
        # e.g. a wildly-off guess or an empty masked scan): stop with the
        # pose unchanged instead of propagating a singular solve. The
        # reference would feed a zero H into LDLT here; a framework step
        # must stay finite so downstream state stays usable.
        degenerate = jnp.max(jnp.abs(jnp.diagonal(H))) < 1e-12
        if s.optimizer == "gn":
            d = solve6_ldlt(H + 1e-12 * jnp.eye(6, dtype=H.dtype), -b)
            d = jnp.where(degenerate, 0.0, d)
            delta = se3.se3_exp(d)
            x_new = se3.compose(delta, st.x0)
            trace = (
                st.trace.at[st.it].set(x_new) if s.record_trace else st.trace
            )
            return _LMState(
                x_new,
                lam,
                _is_converged(delta, s) | degenerate,
                st.failed,
                st.it + 1,
                y0,
                H,
                trace,
            )
        x_new, lam, done, accepted, conv_rej, delta = lm_inner(
            st.x0, lam, y0, H, b, aux
        )
        converged = jnp.where(
            conv_rej, True, jnp.where(accepted, _is_converged(delta, s), False)
        )
        failed = ~done  # lm_max_iterations exhausted: "lm not converged!!"
        x_new = jnp.where(degenerate, st.x0, x_new)
        converged = converged | degenerate
        failed = failed & ~degenerate
        H_final = jnp.where(accepted & ~degenerate, H, st.H)
        trace = st.trace.at[st.it].set(x_new) if s.record_trace else st.trace
        return _LMState(
            x_new, lam, converged, failed, st.it + 1, y0, H_final, trace
        )

    n_trace = s.max_iterations if s.record_trace else 0
    init = _LMState(
        guess.astype(jnp.float32),
        jnp.float32(-1.0),
        jnp.bool_(False),
        jnp.bool_(False),
        jnp.int32(0),
        jnp.float32(0.0),
        jnp.eye(6, dtype=jnp.float32),
        jnp.zeros((n_trace, 4, 4), jnp.float32),
    )
    st = jax.lax.while_loop(outer_cond, outer_body, init)

    # Final residuals/correspondences at the final pose (getResiduals,
    # odom.cc:792-793 -> nano_gicp_impl.hpp:199-232: a fresh per-point NN
    # query at the final T). Skipped when the caller doesn't consume
    # residuals (the reference never calls getResiduals on gicp_s2s).
    if s.compute_residuals:
        # the residual export feeds the detection module's residual image
        # (avg_residuum thresholds, detection.cpp:700-724), so it should
        # carry the TRUE NN distance like getResiduals (nano_gicp_impl.
        # hpp:199-232). With the block-sparse kernel, pruned points
        # carry a saturated distance that would inflate per-segment
        # averages ~1000x — so the one final pass dilates the pruning
        # radius 3x (exact distances up to 3*max_corr_dist) and clamps
        # at that boundary: a clamped outlier adds <= 3*max_corr/|seg| to
        # a segment's avg residuum, the same order as its true distance.
        dil = 3.0
        if s.nn_impl == "sparse":
            y_fin, H_fin, _, aux = _allsum_lin(
                st.x0, "sparse", prune_dilation=dil
            )
            res_cap = dil * s.max_correspondence_distance
        else:
            y_fin, H_fin, _, aux = lin(st.x0)
            res_cap = 1.0e3  # exact backends: keep debug images renderable
        idx, valid, _, _, sqd = aux
        residuals = (
            jnp.minimum(jnp.sqrt(jnp.maximum(sqd, 0.0)), res_cap) * src_mask
        )
        corr = jnp.where(valid, idx, -1)
        num_inliers = _allsum(jnp.sum(valid.astype(jnp.int32)))
    else:
        y_fin, H_fin = st.y, st.H
        residuals = jnp.zeros((src_pts.shape[0],), jnp.float32)
        corr = jnp.full((src_pts.shape[0],), -1, jnp.int32)
        # converged runs always had >= 1 inlier (degenerate runs flag
        # converged too, but with y=H=0 — approximate with the mask count)
        num_inliers = _allsum(jnp.sum(src_mask.astype(jnp.int32)))
    if s.record_trace:
        pose_trace = jnp.where(
            (jnp.arange(s.max_iterations) < st.it)[:, None, None],
            st.trace,
            st.x0[None],
        )
    else:
        pose_trace = st.trace
    return GICPResult(
        T=st.x0,
        converged=st.converged & (num_inliers > 0),
        iterations=st.it,
        final_error=y_fin,
        final_hessian=H_fin,
        num_inliers=num_inliers,
        residuals=residuals,
        correspondences=corr,
        pose_trace=pose_trace,
    )
