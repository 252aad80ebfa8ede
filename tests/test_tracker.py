import numpy as np

import jax.numpy as jnp

from dynamic_direct_lidar_odometry.config import TrackingConfig
from dynamic_direct_lidar_odometry.ops import kalman
from dynamic_direct_lidar_odometry.ops.bbox import Objects
from dynamic_direct_lidar_odometry.tracking import tracker
from dynamic_direct_lidar_odometry.tracking.tracker import (
    DYNAMIC,
    STATIC,
    UNDEFINED,
)

def make_dets(specs, max_slots=8):
    """specs: list of (center_xyz, dims, avg_res) tuples."""
    S = max_slots
    state = np.zeros((S, 7), np.float32)
    npts = np.zeros((S,), np.float32)
    res = np.zeros((S,), np.float32)
    valid = np.zeros((S,), bool)
    for i, (c, d, r) in enumerate(specs):
        state[i, :3] = c
        state[i, 4:7] = d
        npts[i] = 100
        res[i] = r
        valid[i] = True
    return Objects(
        state=jnp.asarray(state),
        num_points=jnp.asarray(npts),
        density=jnp.asarray(npts),
        avg_residuum=jnp.asarray(res),
        valid=jnp.asarray(valid),
    )


def _mkcfg(**kw):
    base = dict(
        max_no_hits=3,
        min_dynamic_hits=3,
        max_undefined_hits=5,
        max_obj_velocity=15.0,
        min_dist_from_origin=0.75,
        residuum_height_ratio=0.1,
    )
    base.update(kw)
    return TrackingConfig(**base)


def test_moving_object_becomes_dynamic_static_stays():
    cfg = _mkcfg()
    # residuum_height_ratio = 0.1 comes from detection cfg; tracker reads
    # cfg.residuum_height_ratio
    assert hasattr(cfg, "residuum_height_ratio")
    st = tracker.empty_state(8)
    dims = (1.0, 1.0, 1.8)
    statuses = []
    for k in range(8):
        dets = make_dets(
            [
                ((0.5 * k, 0.0, 0.9), dims, 0.5),  # mover, high residuum
                ((5.0, 5.0, 0.9), dims, 0.0),  # parked, zero residuum
            ]
        )
        st, out = tracker.update(cfg, st, dets, jnp.float32(0.1))
        statuses.append(np.asarray(st.status)[np.asarray(st.active)])

    active = np.asarray(st.active)
    assert active.sum() == 2
    stat = np.asarray(st.status)
    ids = np.asarray(st.filter_id)
    # two persistent tracks with stable ids
    assert (ids[active] >= 0).all()
    # the mover turned DYNAMIC, the parked object turned STATIC
    fx = np.asarray(st.first_xy)[active]
    mover_slot = np.argmin(np.abs(fx[:, 0] - 0.0) + np.abs(fx[:, 1] - 0.0))
    slots = np.where(active)[0]
    mover, parked = slots[mover_slot], slots[1 - mover_slot]
    assert stat[mover] == DYNAMIC
    assert stat[parked] == STATIC
    hits = np.asarray(st.hits)
    assert hits[mover] == 8 and hits[parked] == 8


def test_low_residuum_mover_stays_static():
    """The avg-residuum gate: motion without ICP residuals is not dynamic
    (bounding_box_filter.cpp:190-193)."""
    cfg = _mkcfg()
    st = tracker.empty_state(8)
    for k in range(8):
        dets = make_dets([((0.5 * k, 0.0, 0.9), (1.0, 1.0, 1.8), 0.0)])
        st, _ = tracker.update(cfg, st, dets, jnp.float32(0.1))
    stat = np.asarray(st.status)[np.asarray(st.active)]
    assert (stat == STATIC).all()


def test_track_eviction_after_max_no_hits():
    cfg = _mkcfg(max_no_hits=3)
    st = tracker.empty_state(8)
    dets = make_dets([((0.0, 0.0, 0.9), (1.0, 1.0, 1.8), 0.5)])
    st, _ = tracker.update(cfg, st, dets, jnp.float32(0.1))
    assert int(np.asarray(st.active).sum()) == 1
    empty = make_dets([])
    for _ in range(3):
        st, _ = tracker.update(cfg, st, empty, jnp.float32(0.1))
    assert int(np.asarray(st.active).sum()) == 0


def test_velocity_gate_unmatches():
    """A detection jumping farther than maxVel*dt must spawn a new track
    instead of matching (tracking.cpp:137-148)."""
    cfg = _mkcfg(max_obj_velocity=5.0)
    st = tracker.empty_state(8)
    st, _ = tracker.update(
        cfg, st, make_dets([((0.0, 0.0, 0.9), (1, 1, 1.8), 0.5)]), jnp.float32(0.1)
    )
    # jump 10 m in 0.1 s: > 5 m/s * 0.1 s
    st, out = tracker.update(
        cfg, st, make_dets([((10.0, 0.0, 0.9), (1, 1, 1.8), 0.5)]), jnp.float32(0.1)
    )
    assert int(np.asarray(st.active).sum()) == 2
    assert int(np.asarray(out.matched)[0]) == -1


def test_turned_dynamic_emits_bbox_history():
    """STATIC -> DYNAMIC transition must emit the rolling bbox history
    for map clearing (tracking.cpp:257-282, bounding_box_filter.cpp:157-167)."""
    cfg = _mkcfg(min_dynamic_hits=2, max_undefined_hits=1, min_dist_from_origin=0.5)
    st = tracker.empty_state(4)
    # sit still twice -> STATIC with history
    for k in range(3):
        st, out = tracker.update(
            cfg, st, make_dets([((0.0, 0.0, 0.9), (1, 1, 1.8), 0.5)]),
            jnp.float32(0.1),
        )
    assert np.asarray(st.status)[0] == STATIC
    assert int(np.asarray(st.bbox_hist_len)[0]) >= 1
    # now move 1 m (inside the 15 m/s * 0.1 s velocity gate) -> DYNAMIC
    st, out = tracker.update(
        cfg, st, make_dets([((1.0, 0.0, 0.9), (1, 1, 1.8), 0.5)]), jnp.float32(0.1)
    )
    assert np.asarray(st.status)[0] == DYNAMIC
    assert bool(np.asarray(out.clear_map_valid)[0].any())
    assert int(np.asarray(st.bbox_hist_len)[0]) == 0


def test_kalman_predict_update_oracle():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 10)).astype(np.float32)
    P = np.tile(np.eye(10, dtype=np.float32) * 2.0, (3, 1, 1))
    dt = 0.25
    xn, Pn = kalman.predict(jnp.asarray(x), jnp.asarray(P), jnp.float32(dt))
    A = np.asarray(kalman.transition_matrix(jnp.float32(dt)))
    Q = np.asarray(kalman.process_noise())
    np.testing.assert_allclose(np.asarray(xn), x @ A.T, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(Pn), A @ P @ A.T + Q, rtol=1e-5, atol=1e-5
    )
    y = rng.normal(size=(3, 7)).astype(np.float32)
    xu, Pu = kalman.update(jnp.asarray(xn), jnp.asarray(Pn), jnp.asarray(y))
    C = np.asarray(kalman.measurement_matrix())
    R = np.asarray(kalman.measurement_noise())
    for i in range(3):
        Pi = np.asarray(Pn)[i]
        K = Pi @ C.T @ np.linalg.inv(C @ Pi @ C.T + R)
        xr = np.asarray(xn)[i] + K @ (y[i] - C @ np.asarray(xn)[i])
        Pr = (np.eye(10) - K @ C) @ Pi
        np.testing.assert_allclose(np.asarray(xu)[i], xr, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(Pu)[i], Pr, rtol=1e-4, atol=1e-4)
