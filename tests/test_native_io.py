"""Native (C++) scan-IO runtime tests: PCD parse + threaded prefetch."""

import os

import numpy as np
import pytest

from dynamic_direct_lidar_odometry.io import native, pcd

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no native toolchain"
)


def _write_scans(tmp_path, n=5, points=200, with_nan=True):
    rng = np.random.default_rng(0)
    paths = []
    clouds = []
    for i in range(n):
        pts = rng.normal(size=(points, 3)).astype(np.float32)
        mask = np.ones(points, bool)
        if with_nan:
            mask[:: 7 + i] = False
        path = os.path.join(tmp_path, f"scan_{i:04d}.pcd")
        # write ALL rows (invalid as NaN), like an organized cloud dump
        full = np.where(mask[:, None], pts, np.nan).astype(np.float32)
        _write_raw_pcd(path, full, binary=(i % 2 == 0))
        paths.append(path)
        clouds.append((pts, mask))
    return paths, clouds


def _write_raw_pcd(path, pts, binary):
    
    n = len(pts)
    hdr = (
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n"
        f"TYPE F F F\nCOUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
        f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(hdr.encode())
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode())


def test_native_load_pcd_matches_python(tmp_path):
    paths, clouds = _write_scans(tmp_path, n=2)
    for path, (pts, mask) in zip(paths, clouds):
        xyz, m = native.load_pcd_native(path, capacity=256)
        assert m.sum() == mask.sum()
        np.testing.assert_allclose(xyz[:200][mask], pts[mask], atol=1e-5)
        assert not m[200:].any()  # padded tail invalid


def test_prefetching_reader_streams_in_order(tmp_path):
    paths, clouds = _write_scans(tmp_path, n=5)
    stamps = [10.0 + 0.1 * i for i in range(5)]
    reader = native.PrefetchingReader(paths, capacity=256, stamps=stamps)
    assert len(reader) == 5
    got = list(reader)
    assert len(got) == 5
    for i, (xyz, m, ts) in enumerate(got):
        pts, mask = clouds[i]
        assert ts == pytest.approx(stamps[i])
        assert m.sum() == mask.sum()
        np.testing.assert_allclose(xyz[:200][mask], pts[mask], atol=1e-5)
    reader.close()


def test_native_agrees_with_python_reader_on_saved_map(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    path = os.path.join(tmp_path, "map.pcd")
    pcd.save_pcd(path, pts, np.ones(300, bool), binary=True)
    xyz, m = native.load_pcd_native(path, capacity=300)
    assert m.all()
    np.testing.assert_allclose(xyz, pts, atol=1e-6)


def test_native_pcd_writer_roundtrip(tmp_path):
    import numpy as np

    from dynamic_direct_lidar_odometry.io import native, pcd

    if not native.available():
        import pytest

        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.7
    path = str(tmp_path / "out.pcd")
    n = native.save_pcd_native(path, pts, mask)
    assert n == int(mask.sum())
    back, fields = pcd.load_pcd(path)
    np.testing.assert_allclose(back[:, :3], pts[mask], atol=1e-6)


def test_save_pcd_dispatches_native(tmp_path):
    import numpy as np

    from dynamic_direct_lidar_odometry.io import pcd

    pts = np.random.default_rng(1).uniform(-5, 5, (100, 3)).astype(np.float32)
    path = str(tmp_path / "a.pcd")
    n = pcd.save_pcd(path, pts, np.ones(100, bool))
    assert n == 100
    back, _ = pcd.load_pcd(path)
    np.testing.assert_allclose(back[:, :3], pts, atol=1e-6)
