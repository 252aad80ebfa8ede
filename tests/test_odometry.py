import dataclasses

import numpy as np

import jax.numpy as jnp

from dynamic_direct_lidar_odometry import config as cfg_lib
from dynamic_direct_lidar_odometry.io import synthetic
from dynamic_direct_lidar_odometry.odometry import keyframes as kf
from dynamic_direct_lidar_odometry.odometry import odometry, preprocess


def small_cfg(**cap_overrides):
    cfg = cfg_lib.doals_config()
    cap = dataclasses.replace(
        cfg.capacity,
        max_points=4096,
        max_keyframe_points=4096,
        max_keyframes=32,
        max_submap_points=16384,
        **cap_overrides,
    )
    det = dataclasses.replace(cfg.detection, rows=32, columns=512)
    pre = dataclasses.replace(
        cfg.preprocessing,
        downsampling=dataclasses.replace(cfg.preprocessing.downsampling, col=2),
        voxel_scan=dataclasses.replace(cfg.preprocessing.voxel_scan, res=0.4),
        voxel_submap=dataclasses.replace(cfg.preprocessing.voxel_submap, res=0.5),
    )
    return dataclasses.replace(cfg, capacity=cap, detection=det, preprocessing=pre)


def render_seq(cfg, n_frames, world=None):
    world = world or synthetic.World.town(seed=0)
    # ~0.6 m / ~5 deg per frame: a 10 Hz-class motion budget (the
    # identity-guess S2S of the reference assumes the same envelope)
    poses = synthetic.circular_trajectory(n_frames, radius=6.0, angle_span=0.5 * np.pi)
    scans = [
        synthetic.render_scan(
            world, T, H=cfg.detection.rows, W=cfg.detection.columns, noise=0.005
        )
        for T in poses
    ]
    return world, poses, scans


def test_preprocess_shapes_and_median():
    cfg = small_cfg()
    world, poses, scans = render_seq(cfg, 1)
    pts, mask = scans[0]
    p = preprocess.preprocess(cfg, jnp.asarray(np.nan_to_num(pts)), jnp.asarray(mask))
    assert p.points.shape == (cfg.capacity.max_points, 3)
    assert int(p.mask.sum()) > 500
    assert 1.0 < float(p.spaciousness_median) < 60.0


def test_odometry_tracks_trajectory():
    """Plain-DLO slice: ATE on a synthetic arc must be centimetric."""
    cfg = small_cfg()
    n = 16
    world, poses, scans = render_seq(cfg, n)

    pts0, m0 = scans[0]
    state = odometry.init_state(
        cfg, jnp.asarray(np.nan_to_num(pts0)), jnp.asarray(m0), jnp.asarray(poses[0])
    )

    est = [np.asarray(state.pose)]
    for i in range(1, n):
        pts, m = scans[i]
        state, out = odometry.step(
            cfg, state, jnp.asarray(np.nan_to_num(pts)), jnp.asarray(m)
        )
        state, added = odometry.update_keyframes(
            cfg, state, out.reg_points_world, out.reg_mask
        )
        assert bool(out.s2m_converged), f"s2m diverged at frame {i}"
        est.append(np.asarray(out.pose))

    gt = np.stack([T[:3, 3] for T in poses])
    est = np.stack(est)
    ate = np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1)))
    assert ate < 0.05, f"ATE {ate:.3f} m"
    # multiple keyframes along a 15 m arc
    assert int(state.store.count) >= 2


def test_keyframe_decision_thresholds():
    cfg = small_cfg()
    world, poses, scans = render_seq(cfg, 1)
    pts0, m0 = scans[0]
    state = odometry.init_state(cfg, jnp.asarray(np.nan_to_num(pts0)), jnp.asarray(m0))
    # same pose: no keyframe
    assert not bool(
        odometry.keyframe_decision(cfg, state, state.pose, state.rotq)
    )
    # far pose: keyframe (threshold is adaptive but <= 10)
    far = state.pose + jnp.asarray([50.0, 0.0, 0.0])
    assert bool(odometry.keyframe_decision(cfg, state, far, state.rotq))


def test_submap_selection_topk_with_ties():
    store = kf.empty_store(8, 16)
    # place 5 keyframes on a line
    for i in range(5):
        store = kf.add_keyframe(
            store,
            jnp.bool_(True),
            jnp.asarray([float(i), 0.0, 0.0]),
            jnp.asarray([1.0, 0, 0, 0]),
            jnp.zeros((16, 3)),
            jnp.ones((16,), bool),
            jnp.tile(jnp.eye(3), (16, 1, 1)),
        )
    sel = kf.select_submap(
        store, jnp.asarray([0.0, 0.0, 0.0]), jnp.float32(1.0), 2, 2, 2
    )
    sel = np.asarray(sel)
    # nearest-2 = {0, 1}; hulls need >=4/5 frames: convex picks the line
    # endpoints {0, 4} (extremal); selection is their union with top-2 gating
    assert sel[0] and sel[1]
    assert sel[:5].sum() >= 2 and not sel[5:].any()


def test_convex_hull_mask_square():
    pos = jnp.asarray(
        np.array(
            [
                [0, 0, 0],
                [4, 0, 0],
                [4, 4, 0],
                [0, 4, 0],
                [2, 2, 0],  # interior
            ],
            np.float32,
        )
    )
    valid = jnp.ones(5, bool)
    m = np.asarray(kf.convex_hull_mask(pos, valid))
    assert m[:4].all()
    assert not m[4]


def test_gather_submap_compacts_blocks():
    """Compacted gather packs every selected keyframe's valid points into
    the capacity buffer with identity covariance padding."""
    import jax.numpy as jnp
    import numpy as np

    from dynamic_direct_lidar_odometry.odometry import keyframes as kf

    store = kf.empty_store(4, 8)
    rng = np.random.default_rng(0)
    for i in range(3):
        pts = jnp.asarray(rng.uniform(-5, 5, (8, 3)).astype(np.float32))
        msk = jnp.asarray(np.arange(8) < (3 + i))  # 3, 4, 5 valid
        covs = jnp.broadcast_to(jnp.eye(3) * (i + 2.0), (8, 3, 3))
        store = kf.add_keyframe(
            store, jnp.bool_(True), jnp.zeros(3) + i,
            jnp.asarray([1.0, 0, 0, 0]), pts, msk, covs,
        )
    sel = jnp.asarray([True, False, True, False])
    pts, msk, covs = kf.gather_submap(store, sel, max_slots=3, capacity=16)
    assert pts.shape == (16, 3) and covs.shape == (16, 3, 3)
    assert int(msk.sum()) == 3 + 5  # keyframes 0 and 2
    # valid rows are contiguous at the front
    m = np.asarray(msk)
    assert np.all(m[: m.sum()]) and not np.any(m[m.sum():])
    # covariance of the first block's rows is the stored one (scale 2)
    np.testing.assert_allclose(np.asarray(covs[0]), np.eye(3) * 2.0)
    np.testing.assert_allclose(np.asarray(covs[3]), np.eye(3) * 4.0)
    # compacted points match the valid subset, in block order
    np.testing.assert_allclose(
        np.asarray(pts[:3]), np.asarray(store.points[0][:3]), atol=1e-6
    )


def test_gather_submap_capacity_overflow_drops_tail():
    import jax.numpy as jnp
    import numpy as np

    from dynamic_direct_lidar_odometry.odometry import keyframes as kf

    store = kf.empty_store(2, 8)
    rng = np.random.default_rng(1)
    for i in range(2):
        pts = jnp.asarray(rng.uniform(-5, 5, (8, 3)).astype(np.float32))
        store = kf.add_keyframe(
            store, jnp.bool_(True), jnp.zeros(3), jnp.asarray([1.0, 0, 0, 0]),
            pts, jnp.ones(8, bool), jnp.broadcast_to(jnp.eye(3), (8, 3, 3)),
        )
    pts, msk, covs = kf.gather_submap(
        store, jnp.asarray([True, True]), max_slots=2, capacity=10
    )
    assert int(msk.sum()) == 10  # 16 valid points, 10 kept


def _insert_kf(store, pos):
    P = store.points.shape[1]
    return kf.add_keyframe(
        store, jnp.bool_(True), jnp.asarray(pos, jnp.float32),
        jnp.asarray([1.0, 0, 0, 0]), jnp.zeros((P, 3)),
        jnp.ones((P,), bool), jnp.broadcast_to(jnp.eye(3), (P, 3, 3)),
    )


def test_keyframe_eviction_preserves_hull_members():
    """Over-capacity inserts evict the farthest NON-HULL keyframe: the
    square's corners (convex hull of the traversed region) survive even
    though they are farther from the current pose than the interior
    frame (keyframes.add_keyframe eviction policy)."""
    store = kf.empty_store(5, 4)
    corners = [
        [0.0, 0.0, 0.0], [20.0, 0.0, 0.0], [20.0, 20.0, 0.0],
        [0.0, 20.0, 0.0],
    ]
    for c in corners:
        store = _insert_kf(store, c)
    store = _insert_kf(store, [10.0, 10.0, 0.0])  # interior, at capacity
    # insert near corner 0: victim must be the interior frame, not the
    # far corners (all true hull vertices)
    store = _insert_kf(store, [1.0, 1.0, 0.0])
    pos = np.asarray(store.positions)
    assert int(np.asarray(store.valid).sum()) == 5
    for c in corners:
        assert np.any(np.all(np.isclose(pos, c), axis=1)), f"corner {c} evicted"
    assert np.any(np.all(np.isclose(pos, [1.0, 1.0, 0.0]), axis=1))
    assert not np.any(np.all(np.isclose(pos, [10.0, 10.0, 0.0]), axis=1))
    assert int(np.asarray(kf.overflow_count(store))) == 1


def test_keyframe_eviction_collinear_slides_window():
    """When every keyframe is a hull vertex (a straight-line sweep), the
    policy degrades to a sliding window: the farthest-overall (oldest)
    frame is evicted, so the store tracks the newest geometry instead of
    freezing the first capacity-1 slots (the round-4 behavior)."""
    store = kf.empty_store(4, 4)
    for i in range(8):
        store = _insert_kf(store, [float(i), 0.0, 0.0])
    xs = sorted(np.asarray(store.positions)[:, 0].tolist())
    assert xs == [4.0, 5.0, 6.0, 7.0], xs
    assert int(np.asarray(kf.overflow_count(store))) == 4


def test_motion_model_guess_stabilizes_fast_rotation():
    """initial_guess_motion=True (constant-velocity S2S seed, new vs the
    reference) tracks a fast constant-rate turn that identity seeding
    loses."""
    import dataclasses

    import numpy as np
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry import config as cfg_lib, pipeline
    from dynamic_direct_lidar_odometry.io import synthetic

    base = cfg_lib.doals_config()
    base = dataclasses.replace(
        base,
        dynamic_detection=False,
        detection=dataclasses.replace(
            base.detection, rows=16, columns=256, ground_rows=4
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=1024, max_submap_points=4096, max_keyframes=16,
            max_keyframe_points=1024, max_objects=4, max_tracks=4,
            nn_chunk=256,
        ),
    )

    def run(cfg):
        world = synthetic.World.town(seed=3, n_static=10)
        rng = np.random.default_rng(0)
        rate = np.deg2rad(9.0)  # 9 deg/scan constant turn
        T = np.eye(4)
        pts, mask = synthetic.render_scan(world, T, H=16, W=256, t=0.0, rng=rng)
        st = pipeline.init_state(cfg, jnp.asarray(pts), jnp.asarray(mask), 0.0)
        errs = []
        for i in range(1, 8):
            th = rate * i
            T = np.eye(4)
            T[0, 0] = T[1, 1] = np.cos(th)
            T[0, 1] = -np.sin(th)
            T[1, 0] = np.sin(th)
            pts, mask = synthetic.render_scan(
                world, T, H=16, W=256, t=0.1 * i, rng=rng
            )
            st, out = pipeline.step(
                cfg, st, jnp.asarray(pts), jnp.asarray(mask),
                jnp.float32(0.1 * i),
            )
            R = np.asarray(out.odom.T)[:3, :3]
            yaw = np.arctan2(R[1, 0], R[0, 0])
            errs.append(abs(yaw - th))
        return max(errs)

    err_motion = run(dataclasses.replace(base, initial_guess_motion=True))
    assert err_motion < np.deg2rad(2.0), np.degrees(err_motion)
