"""Reference-numerics parity: the JAX GICP vs a float64 oracle of the
reference's exact algorithm (tests/reference_oracle.py, a NumPy port of
nano_gicp_impl.hpp:235-441 + lsq_registration_impl.hpp:96-232).

These tests FAIL if the jitted f32 LM diverges from the reference's LM:
same covariances in, the pose trajectory must track the oracle's outer-
iteration trajectory and land within the convergence-epsilon scale
(trans_eps 5e-4 m, rot_eps 2e-3) of the oracle's final pose — the
BASELINE.md accuracy bar (ATE < 5 cm) is two orders of magnitude looser.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

import reference_oracle as oracle
from dynamic_direct_lidar_odometry import config as cfg_lib
from dynamic_direct_lidar_odometry.ops import covariance, gicp


def structured_scene(n=1800, seed=0):
    """A geometrically well-conditioned scene: ground plane, two walls,
    and a ridge, with mild surface noise — the structured-cloud regime
    the reference targets (README.md:14)."""
    rng = np.random.default_rng(seed)
    n1, n2, n3, n4 = n // 3, n // 4, n // 4, n - n // 3 - n // 2
    ground = np.stack(
        [rng.uniform(-8, 8, n1), rng.uniform(-8, 8, n1),
         0.02 * rng.standard_normal(n1)], axis=1)
    wall_a = np.stack(
        [np.full(n2, 6.0) + 0.02 * rng.standard_normal(n2),
         rng.uniform(-8, 8, n2), rng.uniform(0, 3, n2)], axis=1)
    wall_b = np.stack(
        [rng.uniform(-8, 8, n3),
         np.full(n3, -5.0) + 0.02 * rng.standard_normal(n3),
         rng.uniform(0, 3, n3)], axis=1)
    xs = rng.uniform(-8, 8, n4)
    ridge = np.stack(
        [xs, 3.0 + 0.3 * np.sin(xs) + 0.02 * rng.standard_normal(n4),
         1.0 + 0.5 * np.cos(0.7 * xs)], axis=1)
    return np.concatenate([ground, wall_a, wall_b, ridge]).astype(np.float32)


def true_transform(rot_deg=2.0, trans=(0.15, -0.08, 0.03)):
    th = np.deg2rad(rot_deg)
    T = np.eye(4)
    T[:3, :3] = np.array([
        [np.cos(th), -np.sin(th), 0.0],
        [np.sin(th), np.cos(th), 0.0],
        [0.0, 0.0, 1.0],
    ])
    T[:3, 3] = trans
    return T


def _settings_pair(max_iterations=32, max_corr=1.0):
    s_jax = gicp.GICPSettings(
        max_correspondence_distance=max_corr,
        max_iterations=max_iterations,
        record_trace=True,
    )
    s_ora = oracle.OracleSettings(
        max_correspondence_distance=max_corr,
        max_iterations=max_iterations,
    )
    return s_jax, s_ora


def test_covariance_parity():
    """plane_covariances (closed-form I - 0.999 n n^T) vs the oracle's
    SVD-based U diag(1,1,1e-3) V^T (nano_gicp_impl.hpp:414-439)."""
    pts = structured_scene(n=1200, seed=3)
    ours = np.asarray(
        covariance.plane_covariances(
            jnp.asarray(pts), jnp.ones(len(pts), bool), k=20
        )
    )
    ref = oracle.plane_covariances(pts, k=20)
    # same spectrum construction -> should agree to f32 eigvec accuracy
    err = np.linalg.norm(ours - ref, axis=(1, 2))
    assert np.median(err) < 1e-3, np.median(err)
    # near-degenerate neighborhoods may flip close eigenvectors; demand
    # that 99% of points agree tightly
    assert np.quantile(err, 0.99) < 0.05, np.quantile(err, 0.99)


def test_lm_pose_trajectory_parity():
    """The jitted f32 LM must follow the reference LM's outer-iteration
    pose trajectory (lsq_registration_impl.hpp:96-232) given identical
    inputs (same clouds, same covariances, same settings)."""
    src = structured_scene(n=1800, seed=0)
    T_true = true_transform()
    # target: an independent sampling of the same surfaces, transformed
    tgt = structured_scene(n=1800, seed=1) @ T_true[:3, :3].T + T_true[:3, 3]
    tgt = tgt.astype(np.float32)

    src_covs = oracle.plane_covariances(src, k=10)
    tgt_covs = oracle.plane_covariances(tgt, k=10)

    s_jax, s_ora = _settings_pair()
    res_ref = oracle.oracle_align(
        src, tgt, src_covs=src_covs, tgt_covs=tgt_covs, settings=s_ora
    )
    res = gicp.align(
        jnp.asarray(src),
        jnp.ones(len(src), bool),
        jnp.asarray(src_covs, dtype=jnp.float32),
        jnp.asarray(tgt),
        jnp.ones(len(tgt), bool),
        jnp.asarray(tgt_covs, dtype=jnp.float32),
        jnp.eye(4),
        s_jax,
    )

    assert bool(res.converged) and res_ref.converged
    # per-outer-iteration trajectory: f32 vs f64 drift stays below the
    # convergence epsilons at every recorded iteration
    n_cmp = min(int(res.iterations), res_ref.iterations)
    assert n_cmp >= 2
    trace = np.asarray(res.pose_trace)
    for k in range(n_cmp):
        dT = np.linalg.inv(res_ref.pose_trace[k]) @ trace[k]
        t_err = np.linalg.norm(dT[:3, 3])
        r_err = np.abs(dT[:3, :3] - np.eye(3)).max()
        assert t_err < 5e-3, (k, t_err)
        assert r_err < 5e-3, (k, r_err)

    # final pose within the convergence-epsilon scale of the oracle
    dT = np.linalg.inv(res_ref.T) @ np.asarray(res.T)
    assert np.linalg.norm(dT[:3, 3]) < 1e-3
    assert np.abs(dT[:3, :3] - np.eye(3)).max() < 2e-3
    # and both recover the true transform
    dT_true = np.linalg.inv(T_true) @ np.asarray(res.T)
    assert np.linalg.norm(dT_true[:3, 3]) < 0.02


def test_lm_iteration_count_parity():
    """Outer-iteration counts match (same accept/reject decisions along
    the λ path) on a well-conditioned problem."""
    src = structured_scene(n=1500, seed=7)
    T_true = true_transform(rot_deg=1.0, trans=(0.06, 0.04, -0.02))
    tgt = structured_scene(n=1500, seed=8) @ T_true[:3, :3].T + T_true[:3, 3]
    tgt = tgt.astype(np.float32)
    src_covs = oracle.plane_covariances(src, k=10)
    tgt_covs = oracle.plane_covariances(tgt, k=10)
    s_jax, s_ora = _settings_pair()
    res_ref = oracle.oracle_align(
        src, tgt, src_covs=src_covs, tgt_covs=tgt_covs, settings=s_ora
    )
    res = gicp.align(
        jnp.asarray(src), jnp.ones(len(src), bool),
        jnp.asarray(src_covs, dtype=jnp.float32),
        jnp.asarray(tgt), jnp.ones(len(tgt), bool),
        jnp.asarray(tgt_covs, dtype=jnp.float32),
        jnp.eye(4), s_jax,
    )
    assert abs(int(res.iterations) - res_ref.iterations) <= 1


def test_mini_dlo_trajectory_ate():
    """Full-chain numerics: an oracle-driven mini-DLO (S2S -> S2M against
    the init keyframe, covariance reuse and guess propagation exactly as
    odom.cc:745-851) vs the JAX odometry core over a synthetic sequence.
    ATE must be far under the 5 cm BASELINE.md bar."""
    import jax

    from dynamic_direct_lidar_odometry.io import synthetic
    from dynamic_direct_lidar_odometry.odometry import odometry
    from dynamic_direct_lidar_odometry.odometry import preprocess as prep

    H, W = 32, 512
    cfg = cfg_lib.doals_config()
    cfg = dataclasses.replace(
        cfg,
        dynamic_detection=False,
        detection=dataclasses.replace(
            cfg.detection, rows=H, columns=W, ground_rows=4
        ),
        preprocessing=dataclasses.replace(
            cfg.preprocessing,
            downsampling=dataclasses.replace(
                cfg.preprocessing.downsampling, row=1, col=2
            ),
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=4096, max_submap_points=8192, max_keyframes=8,
            max_keyframe_points=4096, max_objects=8, max_tracks=8,
            nn_chunk=1024,
        ),
    )
    world = synthetic.World.town(seed=5, n_static=10)
    n_scans = 6
    gt = synthetic.circular_trajectory(n_scans, radius=8.0, angle_span=0.25)
    rng = np.random.default_rng(0)
    scans = [
        synthetic.render_scan(world, T, H=H, W=W, t=0.0, rng=rng)
        for T in gt
    ]

    # ---- JAX odometry chain ----
    state = odometry.init_state(
        cfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1])
    )
    kf0_pts = np.asarray(state.store.points[0])
    kf0_mask = np.asarray(state.store.masks[0])
    jax_poses = []
    for pts, mask in scans[1:]:
        state, out = odometry.step(
            cfg, state, jnp.asarray(pts), jnp.asarray(mask)
        )
        jax_poses.append(np.asarray(out.T))
    # premise: no new keyframes, so both chains register S2M against the
    # init keyframe only
    assert int(jax.device_get(state.store.count)) == 1

    # ---- oracle mini-DLO on identical preprocessed clouds ----
    def prep_np(pts, mask):
        p = prep.preprocess(cfg, jnp.asarray(pts), jnp.asarray(mask))
        m = np.asarray(p.mask)
        return np.asarray(p.points)[m]

    kf0 = kf0_pts[kf0_mask]
    kf0_covs = oracle.plane_covariances(kf0, k=cfg.gicp.s2s.k_correspondences)
    s2s_set = oracle.OracleSettings(
        max_correspondence_distance=cfg.gicp.s2s.max_correspondence_distance,
        max_iterations=cfg.gicp.s2s.max_iterations,
        transformation_epsilon=cfg.gicp.s2s.transformation_epsilon,
    )
    s2m_set = oracle.OracleSettings(
        max_correspondence_distance=cfg.gicp.s2m.max_correspondence_distance,
        max_iterations=cfg.gicp.s2m.max_iterations,
        transformation_epsilon=cfg.gicp.s2m.transformation_epsilon,
    )
    prev = prep_np(*scans[0])
    prev_covs = oracle.plane_covariances(
        prev, k=cfg.gicp.s2s.k_correspondences
    )
    T = np.eye(4)
    ora_poses = []
    for pts, mask in scans[1:]:
        cur = prep_np(pts, mask)
        cur_covs = oracle.plane_covariances(
            cur, k=cfg.gicp.s2s.k_correspondences
        )
        # S2S (odom.cc:754-762), identity guess
        g = oracle.OracleGICP(s2s_set)
        g.set_target(prev, prev_covs)
        g.set_source(cur, cur_covs)
        rel = g.align(np.eye(4)).T
        T_s2s = T @ rel
        # S2M against the init keyframe, S2S pose as guess, covariance
        # reuse s2s->s2m (odom.cc:765,787-790)
        g = oracle.OracleGICP(s2m_set)
        g.set_target(kf0, kf0_covs)
        g.set_source(cur, cur_covs)
        T = g.align(T_s2s).T
        ora_poses.append(T.copy())
        prev, prev_covs = cur, cur_covs

    jax_xyz = np.stack([P[:3, 3] for P in jax_poses])
    ora_xyz = np.stack([P[:3, 3] for P in ora_poses])
    ate = float(np.sqrt(np.mean(np.sum((jax_xyz - ora_xyz) ** 2, axis=1))))
    assert ate < 0.05, f"ATE vs reference-numerics oracle: {ate:.4f} m"
    # rotation agreement as well
    for Pt, Po in zip(jax_poses, ora_poses):
        dR = np.abs(Pt[:3, :3] @ Po[:3, :3].T - np.eye(3)).max()
        assert dR < 0.02, dR
