"""Float64 NumPy oracle of the reference's GICP numerics.

An independent re-implementation (NOT a port of the JAX code paths) of
exactly what the reference computes, used to prove the JAX GICP
follows the reference's Levenberg-Marquardt trajectory:

- ``plane_covariances``  = NanoGICP::calculate_covariances with
  RegularizationMethod::PLANE (nano_gicp_impl.hpp:375-441): k-NN
  (kd-tree, self included), cov = X_c X_c^T / k, SVD spectrum replaced
  by (1, 1, 1e-3).
- ``OracleGICP.align``   = LsqRegistration::computeTransformation
  (lsq_registration_impl.hpp:96-126) with step_lm (:176-232) over
  NanoGICP::update_correspondences/linearize/compute_error
  (nano_gicp_impl.hpp:235-371). All accumulation in float64, matching
  the reference's double math over float32-stored points; the NN query
  point is computed in float32 like the reference's ``trans_f``
  (nano_gicp_impl.hpp:252).

kd-tree queries via scipy.spatial.cKDTree (exact, like nanoflann).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
from scipy.spatial import cKDTree


def so3_exp(omega: np.ndarray) -> np.ndarray:
    """Quaternion exponential map -> rotation matrix (so3.hpp:101-124)."""
    omega = np.asarray(omega, dtype=np.float64)
    theta_sq = float(omega @ omega)
    if theta_sq < 1e-10:
        theta_quad = theta_sq * theta_sq
        imag = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
        real = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    else:
        theta = np.sqrt(theta_sq)
        imag = np.sin(0.5 * theta) / theta
        real = np.cos(0.5 * theta)
    w, x, y, z = real, *(imag * omega)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def skew(v: np.ndarray) -> np.ndarray:
    """3x3 skew-symmetric matrix (so3.hpp:50-74)."""
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def plane_covariances(points: np.ndarray, k: int) -> np.ndarray:
    """PLANE-regularized per-point covariances (nano_gicp_impl.hpp:375-441).

    Neighborhoods of size k (self included, as the query point is a cloud
    member), covariance normalized by k, SVD singular values replaced by
    (1, 1, 1e-3). Batched over points (float64 throughout — summation
    order differences vs the reference's sequential loop are ~1e-15)."""
    pts32 = np.asarray(points, dtype=np.float32)
    tree = cKDTree(pts32)
    _, idx = tree.query(pts32, k=k)
    neigh = pts32[idx].astype(np.float64)  # (N, k, 3)
    neigh -= neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", neigh, neigh) / k
    U, _, Vt = np.linalg.svd(cov)
    return np.einsum("nij,j,njk->nik", U, np.array([1.0, 1.0, 1e-3]), Vt)


@dataclasses.dataclass
class OracleSettings:
    """LsqRegistration ctor defaults (lsq_registration_impl.hpp:53-61)."""

    max_correspondence_distance: float = 1.0
    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9


@dataclasses.dataclass
class OracleResult:
    T: np.ndarray  # (4, 4) float64 final pose
    converged: bool
    iterations: int
    pose_trace: List[np.ndarray]  # x0 after each outer iteration
    final_error: float


class OracleGICP:
    """The reference's GICP align, double precision, host-side."""

    def __init__(self, settings: OracleSettings = OracleSettings()):
        self.s = settings

    def set_target(self, tgt_points: np.ndarray, tgt_covs: np.ndarray):
        self.tgt32 = np.asarray(tgt_points, dtype=np.float32)
        self.tgt64 = self.tgt32.astype(np.float64)
        self.tgt_covs = np.asarray(tgt_covs, dtype=np.float64)
        self.tree = cKDTree(self.tgt32)

    def set_source(self, src_points: np.ndarray, src_covs: np.ndarray):
        self.src32 = np.asarray(src_points, dtype=np.float32)
        self.src64 = self.src32.astype(np.float64)
        self.src_covs = np.asarray(src_covs, dtype=np.float64)

    # -- update_correspondences (nano_gicp_impl.hpp:235-275) --------------
    def _correspondences(self, T: np.ndarray):
        T32 = T.astype(np.float32)
        q = self.src32 @ T32[:3, :3].T + T32[:3, 3]  # trans_f * p, f32
        sqd, idx = self.tree.query(q.astype(np.float32), k=1)
        sqd = np.square(sqd.astype(np.float32))
        thresh = np.float32(self.s.max_correspondence_distance) ** 2
        corr = np.where(sqd < thresh, idx, -1)
        # mahalanobis = inv(cov_B + T cov_A T^T) per valid pair (:261-267)
        R = T[:3, :3]
        valid = corr >= 0
        M = np.zeros((len(self.src64), 3, 3), dtype=np.float64)
        if valid.any():
            RCR = (
                self.tgt_covs[corr[valid]]
                + np.einsum("ij,njk,lk->nil", R, self.src_covs[valid], R)
            )
            M[valid] = np.linalg.inv(RCR)
        return corr, M

    # -- linearize (nano_gicp_impl.hpp:278-342) ---------------------------
    def _linearize(self, T: np.ndarray):
        corr, M = self._correspondences(T)
        R, t = T[:3, :3], T[:3, 3]
        v = corr >= 0
        if not v.any():
            return 0.0, np.zeros((6, 6)), np.zeros(6), (corr, M)
        a = self.src64[v]
        bb = self.tgt64[corr[v]]
        Mv = M[v]
        ta = a @ R.T + t  # (n, 3) transed_mean_A
        e = bb - ta
        Me = np.einsum("nij,nj->ni", Mv, e)
        y = float(np.einsum("ni,ni->", e, Me))
        # J = [skew(T a) | -I] per point (:320-325)
        n = len(a)
        J = np.zeros((n, 3, 6))
        J[:, 0, 1] = -ta[:, 2]
        J[:, 0, 2] = ta[:, 1]
        J[:, 1, 0] = ta[:, 2]
        J[:, 1, 2] = -ta[:, 0]
        J[:, 2, 0] = -ta[:, 1]
        J[:, 2, 1] = ta[:, 0]
        J[:, :3, 3:] = -np.eye(3)
        MJ = np.einsum("nij,njk->nik", Mv, J)
        H = np.einsum("nji,njk->ik", J, MJ)
        b = np.einsum("nji,nj->i", J, Me)
        return y, H, b, (corr, M)

    # -- compute_error (nano_gicp_impl.hpp:345-371): correspondences and
    # mahalanobis frozen from the last linearize --------------------------
    def _error(self, T: np.ndarray, aux) -> float:
        corr, M = aux
        v = corr >= 0
        if not v.any():
            return 0.0
        R, t = T[:3, :3], T[:3, 3]
        e = self.tgt64[corr[v]] - (self.src64[v] @ R.T + t)
        return float(np.einsum("ni,nij,nj->", e, M[v], e))

    def _is_converged(self, delta: np.ndarray) -> bool:
        """lsq_registration_impl.hpp:129-139."""
        r = np.abs(delta[:3, :3] - np.eye(3)) / self.s.rotation_epsilon
        t = np.abs(delta[:3, 3]) / self.s.transformation_epsilon
        return max(r.max(), t.max()) < 1.0

    def _step_lm(self, x0: np.ndarray, lm_lambda: float):
        """step_lm (lsq_registration_impl.hpp:176-232). Returns
        (ok, x0', lambda', delta, y0)."""
        y0, H, b, aux = self._linearize(x0)
        if lm_lambda < 0.0:
            lm_lambda = self.s.lm_init_lambda_factor * np.abs(
                np.diag(H)
            ).max()
        nu = 2.0
        delta = np.eye(4)
        for _ in range(self.s.lm_max_iterations):
            d = np.linalg.solve(H + lm_lambda * np.eye(6), -b)
            delta = np.eye(4)
            delta[:3, :3] = so3_exp(d[:3])
            delta[:3, 3] = d[3:]
            xi = delta @ x0
            yi = self._error(xi, aux)
            rho = (y0 - yi) / (d @ (lm_lambda * d - b))
            if rho < 0:
                if self._is_converged(delta):
                    return True, x0, lm_lambda, delta, y0
                lm_lambda = nu * lm_lambda
                nu = 2.0 * nu
                continue
            lm_lambda *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            return True, xi, lm_lambda, delta, y0
        return False, x0, lm_lambda, delta, y0

    def align(self, guess: np.ndarray) -> OracleResult:
        """computeTransformation (lsq_registration_impl.hpp:96-126)."""
        x0 = np.asarray(guess, dtype=np.float64).copy()
        lm_lambda = -1.0
        converged = False
        trace: List[np.ndarray] = []
        y0 = 0.0
        it = 0
        for it in range(self.s.max_iterations):
            ok, x0, lm_lambda, delta, y0 = self._step_lm(x0, lm_lambda)
            trace.append(x0.copy())
            if not ok:  # "lm not converged!!" break (:116-119)
                break
            converged = self._is_converged(delta)
            if converged:
                break
        return OracleResult(
            T=x0, converged=converged, iterations=it + 1,
            pose_trace=trace, final_error=y0,
        )


def oracle_align(
    src: np.ndarray,
    tgt: np.ndarray,
    guess: Optional[np.ndarray] = None,
    k_covariances: int = 20,
    src_covs: Optional[np.ndarray] = None,
    tgt_covs: Optional[np.ndarray] = None,
    settings: OracleSettings = OracleSettings(),
) -> OracleResult:
    """Convenience one-shot align with covariances computed like
    NanoGICP::computeTransformation does on demand (:184-196)."""
    g = OracleGICP(settings)
    if src_covs is None:
        src_covs = plane_covariances(src, k_covariances)
    if tgt_covs is None:
        tgt_covs = plane_covariances(tgt, k_covariances)
    g.set_target(tgt, tgt_covs)
    g.set_source(src, src_covs)
    return g.align(np.eye(4) if guess is None else guess)
