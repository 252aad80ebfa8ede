import numpy as np

import jax.numpy as jnp
from scipy.spatial import cKDTree

from dynamic_direct_lidar_odometry.core import cloud as cloud_lib
from dynamic_direct_lidar_odometry.ops import covariance


def _ref_plane_covs(pts, k):
    """NumPy oracle reproducing nano_gicp_impl.hpp:375-441 (PLANE)."""
    tree = cKDTree(pts)
    _, idx = tree.query(pts, k=k)
    covs = np.zeros((len(pts), 3, 3))
    for i in range(len(pts)):
        nb = pts[idx[i]].astype(np.float64)
        nb = nb - nb.mean(0)
        cov = nb.T @ nb / k
        U, s, Vt = np.linalg.svd(cov)
        covs[i] = U @ np.diag([1.0, 1.0, 1e-3]) @ Vt
    return covs


def test_plane_covariances_match_oracle():
    rng = np.random.default_rng(0)
    # planar-ish surface with noise: the PLANE model's target case
    xy = rng.uniform(-5, 5, size=(400, 2))
    z = 0.05 * rng.normal(size=400)
    pts = np.column_stack([xy, z]).astype(np.float32)

    covs = np.asarray(
        covariance.plane_covariances(
            jnp.asarray(pts), jnp.ones(len(pts), bool), k=20
        )
    )
    ref = _ref_plane_covs(pts, 20)
    # spectra must match exactly: (1e-3, 1, 1)
    w = np.linalg.eigvalsh(covs)
    np.testing.assert_allclose(w[:, 0], 1e-3, rtol=1e-2)
    np.testing.assert_allclose(w[:, 1:], 1.0, rtol=1e-2)
    # the small-eigenvalue direction (surface normal) must agree
    def min_dir(C):
        vals, vecs = np.linalg.eigh(C)
        return vecs[:, :, 0]

    n_got, n_ref = min_dir(covs), min_dir(ref)
    dots = np.abs(np.sum(n_got * n_ref, axis=1))
    assert np.quantile(dots, 0.05) > 0.99


def test_masked_points_get_identity():
    pts = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    mask = np.ones(64, bool)
    mask[10:20] = False
    c = cloud_lib.Cloud(jnp.asarray(pts), jnp.asarray(mask)).sanitized()
    covs = np.asarray(covariance.plane_covariances(c.points, c.mask, k=5))
    np.testing.assert_allclose(covs[10:20], np.eye(3)[None].repeat(10, 0))


def test_window_self_covariances_on_morton_cloud():
    """The GPU block-window path (platform-gated in plane_covariances,
    but platform-agnostic math — exercised directly here): on a Morton-ordered voxel cloud its PLANE normals must agree
    with the exact k-NN covariances for nearly all points, and invalid
    SENTINEL rows must never enter a real neighborhood."""
    from dynamic_direct_lidar_odometry.ops import filters, knn as knn_ops

    rng = np.random.default_rng(3)
    n = 6000
    # two planes + noise, the covariance estimator's target regime
    g = np.column_stack([
        rng.uniform(-12, 12, n), rng.uniform(-12, 12, n),
        0.04 * rng.normal(size=n),
    ])
    w = np.column_stack([
        np.full(n // 2, 6.0) + 0.04 * rng.normal(size=n // 2),
        rng.uniform(-12, 12, n // 2), rng.uniform(0, 3, n // 2),
    ])
    raw = np.concatenate([g, w]).astype(np.float32)
    pts, mask = filters.voxel_downsample(
        jnp.asarray(raw), jnp.ones(len(raw), bool), 0.25, 8192
    )
    k = 10
    cov_w = covariance.regularize_plane(
        covariance._window_self_covariances(pts, k)
    )
    idx, _ = knn_ops.knn(pts, pts, k)
    neigh = pts[idx]
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov_e = covariance.regularize_plane(
        jnp.einsum("nki,nkj->nij", centered, centered) / k
    )
    m = np.asarray(mask)

    # the quantity GICP consumes is the PLANE surface normal: the block
    # window replaces out-of-window neighbors with the next nearest
    # in-window ones (same-surface points), so the normal barely moves
    # even where neighborhood overlap is partial. Measured: median |dot|
    # 0.9986 (~3 deg), q05 0.985.
    def ndir(C):
        _, vecs = np.linalg.eigh(C)
        return vecs[:, :, 0]

    a, b = ndir(np.asarray(cov_w)[m]), ndir(np.asarray(cov_e)[m])
    dots = np.abs(np.sum(a * b, axis=1))
    assert np.median(dots) > 0.995, np.median(dots)
    assert np.quantile(dots, 0.05) > 0.97, np.quantile(dots, 0.05)
    # finite everywhere (sentinel blocks must not NaN-poison)
    assert np.all(np.isfinite(np.asarray(cov_w)[m]))
