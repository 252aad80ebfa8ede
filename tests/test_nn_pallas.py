"""The block-sparse 1-NN kernel (ops/nn_pallas.py) against the exact XLA
sweep, and the platform choice around it.

On the CPU the kernel runs in the Pallas interpreter, which the tests ask
for explicitly, so these tests check its semantics; the GPU runs the same
kernel code compiled through Triton. The cross-lowering tests lower for
``cuda`` without a card and check which NN path each platform gets.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamic_direct_lidar_odometry.ops import gicp
from dynamic_direct_lidar_odometry.ops import knn as knn_ops
from dynamic_direct_lidar_odometry.ops import nn_pallas

# custom-call target of a Triton-route pallas_call
TRITON_CALL = "__gpu$xla.gpu.triton"
# radius larger than any test cloud: every chunk is active (exact mode)
ALL = 1.0e4

nn1_interp = partial(nn_pallas.nn1_sparse_pallas, interpret=True)


def _clouds(Q=700, T=900, seed=0, sentinel_every=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    t = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    if sentinel_every:
        q[::sentinel_every] = 1.0e6
        t[:: sentinel_every + 1] = 1.0e6
    return jnp.asarray(q), jnp.asarray(t)


def test_nn1_all_chunks_matches_exact():
    q, t = _clouds()
    i0, d0 = knn_ops.nn1(q, t)
    i1, d1 = nn1_interp(q, t, radius=ALL, q_tile=64, t_chunk=128)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), atol=1e-4)


def test_nn1_all_chunks_with_sentinels():
    q, t = _clouds(sentinel_every=13)
    i0, _ = knn_ops.nn1(q, t)
    i1, _ = nn1_interp(q, t, radius=ALL, q_tile=64, t_chunk=128)
    real = np.asarray(q[:, 0]) < 5e5
    np.testing.assert_array_equal(np.asarray(i0)[real], np.asarray(i1)[real])


def test_nn1_all_chunks_nonmultiple_sizes():
    # shapes not divisible by the tile/chunk exercise the padding path
    q, t = _clouds(Q=301, T=517)
    i0, _ = knn_ops.nn1(q, t)
    i1, _ = nn1_interp(q, t, radius=ALL, q_tile=128, t_chunk=256)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_nn1_sparse_matches_exact_within_radius():
    """Exact wherever the true NN is within the pruning radius; gated-out
    queries report a distance >= radius^2."""
    q, t = _clouds(Q=700, T=900, seed=2)
    r = 5.0
    i0, d0 = knn_ops.nn1(q, t)
    i1, d1 = nn1_interp(q, t, radius=r, q_tile=64, t_chunk=128)
    in_range = np.asarray(d0) < r * r
    assert in_range.sum() > 100  # the scene actually exercises both sides
    np.testing.assert_array_equal(
        np.asarray(i0)[in_range], np.asarray(i1)[in_range]
    )
    np.testing.assert_allclose(
        np.asarray(d0)[in_range], np.asarray(d1)[in_range], atol=1e-4
    )
    # gated-out queries never sneak IN-range results
    assert np.all(np.asarray(d1)[~in_range] >= r * r)


def test_nn1_sparse_spatially_sorted_prunes_and_stays_exact():
    """With spatially coherent (voxel-ordered) clouds — the layout the
    pipeline feeds — most chunks are pruned; results stay exact within
    the radius."""
    rng = np.random.default_rng(5)
    t = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    t = t[np.argsort((t[:, 0] // 2.0) * 1000 + t[:, 1] // 2.0)]  # voxel-ish
    q = (t[::3] + rng.normal(0, 0.2, (len(t[::3]), 3))).astype(np.float32)
    r = 1.0
    q, t = jnp.asarray(q), jnp.asarray(t)
    i0, d0 = knn_ops.nn1(q, t)
    i1, d1 = nn1_interp(q, t, radius=r, q_tile=64, t_chunk=128)
    in_range = np.asarray(d0) < r * r
    assert in_range.mean() > 0.9
    np.testing.assert_array_equal(
        np.asarray(i0)[in_range], np.asarray(i1)[in_range]
    )
    # the pruning really prunes: most (tile, chunk) pairs are inactive
    prep = nn_pallas.prepare_sparse_target(t)
    qb = q[: (len(q) // 64) * 64].reshape(-1, 64, 3)
    overlap = jnp.all(
        (qb.min(1)[:, None] - r <= prep.t_hi[None])
        & (qb.max(1)[:, None] + r >= prep.t_lo[None]),
        axis=-1,
    )
    assert float(overlap.mean()) < 0.5


def test_nn1_sparse_with_sentinels_and_padding():
    q, t = _clouds(Q=301, T=517, seed=3, sentinel_every=11)
    r = 8.0
    i0, d0 = knn_ops.nn1(q, t)
    i1, d1 = nn1_interp(q, t, radius=r, q_tile=128, t_chunk=256)
    in_range = np.asarray(d0) < r * r
    np.testing.assert_array_equal(
        np.asarray(i0)[in_range], np.asarray(i1)[in_range]
    )
    assert np.all(np.asarray(d1)[~in_range] >= r * r)


def test_chunk_lists_ascending_and_padded():
    overlap = jnp.asarray(
        [[True, False, True, False, True], [False] * 5, [True] * 5]
    )
    counts, lst = nn_pallas.chunk_lists(overlap)
    assert lst.shape == (3, 8)  # width rounded up to a power of two
    np.testing.assert_array_equal(np.asarray(counts)[:, 0], [3, 0, 5])
    np.testing.assert_array_equal(np.asarray(lst)[0, :3], [0, 2, 4])
    np.testing.assert_array_equal(np.asarray(lst)[2, :5], np.arange(5))


def test_sparse_gicp_parity(monkeypatch):
    """The kernel inside a GICP linearization gives the exact sweep's
    linearization: the pruned pairs are exactly the ones the
    max_corr_dist gate discards."""
    rng = np.random.default_rng(1)
    src = jnp.asarray(rng.uniform(-10, 10, (256, 3)).astype(np.float32))
    tgt = src + jnp.asarray([0.05, 0.0, 0.0])
    mask = jnp.ones((256,), bool)
    covs = jnp.broadcast_to(jnp.eye(3), (256, 3, 3))
    T = jnp.eye(4)

    y_ref, H_ref, b_ref, aux_ref = gicp._linearize(
        T, src, mask, covs, tgt, mask, covs, 1.0
    )

    # take the GPU branch, with the kernel in the interpreter
    monkeypatch.setattr(knn_ops, "on_gpu", lambda gpu, default, *a: gpu(*a))
    monkeypatch.setattr(
        nn_pallas, "nn1_sparse_prepared",
        partial(nn_pallas.nn1_sparse_prepared, interpret=True),
    )
    y_s, H_s, b_s, aux_s = gicp._linearize(
        T, src, mask, covs, tgt, mask, covs, 1.0, nn_impl="sparse"
    )
    np.testing.assert_allclose(float(y_s), float(y_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(H_s), np.asarray(H_ref), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(b_s), np.asarray(b_ref), rtol=1e-4, atol=1e-3
    )
    # the valid (gated-in) correspondence sets agree exactly
    np.testing.assert_array_equal(
        np.asarray(aux_s[1]), np.asarray(aux_ref[1])
    )


# ---------------------------------------------------------------------------
# cross-lowering: which path each platform gets, without a card
# ---------------------------------------------------------------------------


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _lowered_text(fn, args, platform):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("n_target", [16384, 65536])
def test_kernel_lowers_for_cuda_at_bench_width(n_target):
    """S2S (16k x 16k) and S2M (16k x 64k) widths lower through Triton."""
    fn = partial(nn_pallas.nn1_sparse_pallas, radius=1.0)
    text = _lowered_text(fn, (_f32(16384, 3), _f32(n_target, 3)), "cuda")
    assert text.count(TRITON_CALL) == 1


def _align_args(N=256, M=512):
    return (
        _f32(N, 3), jax.ShapeDtypeStruct((N,), jnp.bool_), _f32(N, 3, 3),
        _f32(M, 3), jax.ShapeDtypeStruct((M,), jnp.bool_), _f32(M, 3, 3),
        _f32(4, 4),
    )


_SPARSE = gicp.GICPSettings(nn_impl="sparse")


def test_align_lowers_kernel_for_cuda_only():
    fn = partial(gicp.align, settings=_SPARSE)
    assert TRITON_CALL in _lowered_text(fn, _align_args(), "cuda")
    assert TRITON_CALL not in _lowered_text(fn, _align_args(), "cpu")
    # the exact backend never reaches the kernel
    fn_exact = partial(gicp.align, settings=gicp.GICPSettings(nn_impl="exact"))
    assert TRITON_CALL not in _lowered_text(fn_exact, _align_args(), "cuda")


def test_vmapped_align_lowers_kernel_for_cuda_only():
    fn = jax.vmap(partial(gicp.align, settings=_SPARSE))
    args = tuple(
        jax.ShapeDtypeStruct((3,) + a.shape, a.dtype) for a in _align_args()
    )
    assert TRITON_CALL in _lowered_text(fn, args, "cuda")
    assert TRITON_CALL not in _lowered_text(fn, args, "cpu")


@pytest.mark.gpu
def test_compiled_kernel_matches_exact_on_gpu(gpu_device):
    """Compiled (not interpreted) kernel on the card vs the exact sweep."""
    q, t = _clouds(Q=4096, T=8192, seed=7)
    q, t = jax.device_put((q, t), gpu_device)
    r = 2.0
    i0, d0 = knn_ops.nn1(q, t)
    i1, d1 = nn_pallas.nn1_sparse_pallas(q, t, radius=r)
    in_range = np.asarray(d0) < r * r
    np.testing.assert_array_equal(
        np.asarray(i0)[in_range], np.asarray(i1)[in_range]
    )
    np.testing.assert_allclose(
        np.asarray(d0)[in_range], np.asarray(d1)[in_range], atol=1e-5
    )
    assert np.all(np.asarray(d1)[~in_range] >= r * r)
