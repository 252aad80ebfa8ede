"""Per-point GICP covariance estimation with PLANE regularization.

Functional equivalent of ``NanoGICP::calculate_covariances``
(nano_gicp_impl.hpp:375-441): for every point, take its k nearest
neighbors (including itself), form the neighborhood covariance, and
regularize its spectrum to (1, 1, 1e-3) — the "locally planar" GICP model.

Differences from the reference: the kd-tree k-NN is the exact sweep from
:mod:`.knn` (or, on the GPU, the Morton-block window below), and the
per-point 3x3 JacobiSVD becomes the closed-form smallest eigenvector of
the symmetric PSD covariance (:func:`regularize_plane`) instead of 1e4
sequential host-loop SVDs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.ops import knn as knn_ops


@partial(jax.jit, static_argnames=("k", "morton_ordered"))
def plane_covariances(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    k: int = 20,
    morton_ordered: bool = False,
) -> jnp.ndarray:
    """Compute regularized (N, 3, 3) covariances for a masked cloud.

    Args:
      points: (N, 3) float32; invalid rows already at the SENTINEL.
      mask: (N,) bool validity.
      k: neighborhood size (``kCorrespondences``; 10 for s2s, 20 for s2m in
         cfg/DOALS.yaml:44,54).
      morton_ordered: the caller PROMISES ``points`` rows are Morton
        (z-order) sorted — true exactly for ``filters.voxel_downsample``
        outputs. Gates the GPU window path: on a raw-scan-order
        cloud (``filters.compact``) a +-64-row window spans a single
        azimuth arc and would yield silently degenerate near-collinear
        neighborhoods, so callers must assert the ordering explicitly
        (the producing config's ``voxel_*.use`` flag) instead of the
        path being inferred.

    Returns:
      (N, 3, 3) covariances; invalid points get identity (they are masked
      out of every downstream reduction anyway).
    """
    import os

    def exact(points):
        idx, _ = knn_ops.knn(points, points, k)
        neigh = points[idx]  # (N, k, 3)
        mean = jnp.mean(neigh, axis=1, keepdims=True)
        centered = neigh - mean
        # cov = X^T X / k, matching the reference's normalization
        # (nano_gicp_impl.hpp:398-399). HIGHEST: a TF32 matmul pass
        # drowns the small eigenvalue PLANE regularization keys on.
        return (
            jnp.einsum(
                "nki,nkj->nij", centered, centered,
                precision=jax.lax.Precision.HIGHEST,
            )
            / k
        )

    impl = os.environ.get("DDLO_KNN_IMPL", "window")
    if impl not in ("window", "exact"):
        raise ValueError(f"DDLO_KNN_IMPL must be window or exact, got {impl!r}")
    if morton_ordered and impl == "window":
        cov = knn_ops.on_gpu(
            lambda p: _window_self_covariances(p, k), exact, points
        )
    else:
        cov = exact(points)

    cov_reg = regularize_plane(cov)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=points.dtype), cov_reg.shape)
    return jnp.where(mask[:, None, None], cov_reg, eye)


def _window_self_covariances(
    points: jnp.ndarray, k: int, block: int = 128
) -> jnp.ndarray:
    """Self-neighborhood covariances over a MORTON-BLOCK candidate set.

    The GPU default for the pipeline's self k-NN covariances: callers
    assert via ``morton_ordered=True`` that the cloud is a
    ``filters.voxel_downsample`` output, whose rows are Morton (z-order)
    sorted — spatial neighbors sit close in row order. Each query takes
    its k nearest among the candidates of its 128-row block plus the two
    adjacent blocks (window at least +-128 rows — wider than the old
    +-64 roll-stack, at 3x data redundancy instead of 129x):

      - candidates (nb, 3B, 3) come from two block-rolls + a concat (no
        gathers, no 129-copy roll stack);
      - pairwise distances are ONE batched (B, 3)@(3, 3B) matmul
        per block (HIGHEST: d2 is a difference of |y|^2-sized terms, a
        TF32 pass would garble near-neighbor ordering);
      - selection is the k-th-distance THRESHOLD from lax.top_k values
        (no (N, k, D) winner-mask compare), moments are two weighted
        matmuls over precomputed candidate products.

    Everything is block-centered (y = x - block_anchor, |y| ~ block
    extent) so the f32 E[yy] - mm subtraction never cancels against
    |x|^2-sized terms. SENTINEL rows sit 1e6 away per coordinate (squared
    distance ~1e12), so they lose every distance race; blocks that are entirely sentinel produce garbage
    covariances for rows the caller masks to identity anyway.
    Approximation: a neighbor outside the window is replaced by the next
    nearest inside it — benign for PLANE-regularized covariances
    (tests/test_covariance.py bounds the normal drift; tools/accuracy.py
    measures the end-to-end ATE against the exact legs).
    """
    N = points.shape[0]
    B = block
    pad = (-N) % B
    p = points
    if pad:
        p = jnp.concatenate([p, jnp.full((pad, 3), 3.0e12, points.dtype)])
    nb = p.shape[0] // B
    q = p.reshape(nb, B, 3)
    # anchor: row 0 of each block (voxel clouds are front-packed, so it
    # is valid whenever the block holds any valid row)
    ctr = q[:, 0, :]
    yq = q - ctr[:, None, :]
    c = jnp.concatenate(
        [jnp.roll(q, 1, axis=0), q, jnp.roll(q, -1, axis=0)], axis=1
    )  # (nb, 3B, 3)
    yc = c - ctr[:, None, :]
    qq = jnp.sum(yq * yq, axis=-1)  # (nb, B)
    cc = jnp.sum(yc * yc, axis=-1)  # (nb, 3B)
    cross = jnp.einsum(
        "nbi,nci->nbc", yq, yc, precision=jax.lax.Precision.HIGHEST
    )
    d2 = qq[:, :, None] + cc[:, None, :] - 2.0 * cross  # (nb, B, 3B)
    # k-th smallest distance per query -> threshold weights (ties may
    # push the count past k; normalize by the actual count)
    neg_top, _ = jax.lax.top_k(-d2, k)
    rk = -neg_top[..., k - 1]
    w = (d2 <= rk[..., None]).astype(points.dtype)
    cnt = jnp.maximum(jnp.sum(w, axis=-1), 1.0)  # (nb, B)
    sum_y = jnp.einsum(
        "nbc,nci->nbi", w, yc, precision=jax.lax.Precision.HIGHEST
    )
    # candidate second moments once per candidate, then one weighted
    # matmul: (nb, B, 3B) @ (nb, 3B, 9)
    yy = (yc[:, :, :, None] * yc[:, :, None, :]).reshape(nb, 3 * B, 9)
    sum_yy = jnp.einsum(
        "nbc,ncj->nbj", w, yy, precision=jax.lax.Precision.HIGHEST
    ).reshape(nb, B, 3, 3)
    mean_y = sum_y / cnt[..., None]
    cov = sum_yy / cnt[..., None, None] - (
        mean_y[..., :, None] * mean_y[..., None, :]
    )
    return cov.reshape(nb * B, 3, 3)[:N]


def smallest_eigvec_sym3(A: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Closed form (Cardano eigenvalue + largest cross product of rows of
    ``A - lmin I``) — pure elementwise math, no batched eigh solver.
    Near-isotropic matrices (every direction equally good) fall back to
    e_z, mirroring the arbitrary basis an eigensolver would return.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    ) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    # det(B)/p^3 with B = A - q I
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lmin = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    c00, c11, c22 = a00 - lmin, a11 - lmin, a22 - lmin
    r0 = jnp.stack([c00, a01, a02], axis=-1)
    r1 = jnp.stack([a01, c11, a12], axis=-1)
    r2 = jnp.stack([a02, a12, c22], axis=-1)
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where(
        (n01 >= n02)[..., None] & (n01 >= n12)[..., None],
        c01,
        jnp.where((n02 >= n12)[..., None], c02, c12),
    )
    nrm = jnp.linalg.norm(best, axis=-1, keepdims=True)
    ez = jnp.zeros_like(best).at[..., 2].set(1.0)
    return jnp.where(nrm > 1e-12, best / jnp.maximum(nrm, 1e-30), ez)


@jax.jit
def regularize_plane(cov: jnp.ndarray) -> jnp.ndarray:
    """Spectrum-replace each (..., 3, 3) covariance with (1, 1, 1e-3).

    RegularizationMethod::PLANE (nano_gicp_impl.hpp:423-425,435-436) is
    C_reg = U diag(1, 1, 1e-3) U^T — algebraically ``I - (1 - 1e-3) n n^T``
    with n the unit eigenvector of the SMALLEST eigenvalue (the surface
    normal), since the two in-plane directions get weight 1. Only n is
    needed, so the batched eigh solver is replaced by the closed form.
    """
    n = smallest_eigvec_sym3(cov)
    eye = jnp.eye(3, dtype=cov.dtype)
    return eye - (1.0 - 1e-3) * n[..., :, None] * n[..., None, :]
