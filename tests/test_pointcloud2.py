"""Bag-decode path: PointCloud2 byte-buffer slicing/masking vs
hand-crafted buffers (no ROS installed).

This is the only code between the framework and the reference's real
datasets (launch/play_DOALS_data.launch:2-7); it must survive every
layout the reference's drivers emit: padded point_steps, non-contiguous
x/y/z offsets, NaN no-returns, big-endian data.
"""

from __future__ import annotations

import importlib.util
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from dynamic_direct_lidar_odometry.io import pointcloud2 as pc2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_cloud(
    xyz: np.ndarray,
    point_step: int,
    offsets=(0, 4, 8),
    is_bigendian: bool = False,
    fill: int = 0xAB,
) -> bytes:
    """Serialize (N, 3) float64/float32 rows into a PointCloud2-layout
    buffer with arbitrary stride/offsets; non-coordinate bytes get a
    poison pattern so any mis-slicing shows up as garbage coordinates."""
    n = len(xyz)
    buf = bytearray([fill]) * (n * point_step)
    fmt = (">" if is_bigendian else "<") + "f"
    for i, row in enumerate(np.asarray(xyz, np.float64)):
        base = i * point_step
        for off, v in zip(offsets, row):
            buf[base + off : base + off + 4] = struct.pack(fmt, v)
    return bytes(buf)


RNG = np.random.default_rng(7)
XYZ = np.concatenate(
    [
        RNG.normal(size=(29, 3)) * 10.0,
        [[np.nan, 1.0, 2.0]],          # partial NaN row
        [[np.nan, np.nan, np.nan]],    # full NaN no-return
        [[2.0e6, 0.0, 0.0]],           # huge sentinel coordinate
    ]
).astype(np.float32)


@pytest.mark.parametrize(
    "point_step,offsets",
    [
        (12, (0, 4, 8)),    # tightly packed xyz
        (16, (0, 4, 8)),    # xyz + intensity (DOALS OS1 minimal)
        (32, (0, 4, 8)),    # Ouster-style padded record
        (48, (0, 8, 16)),   # NON-contiguous coordinate fields
    ],
)
def test_decode_layouts(point_step, offsets):
    data = make_cloud(XYZ, point_step, offsets)
    out = pc2.decode_xyz(data, len(XYZ), point_step, offsets)
    np.testing.assert_array_equal(out[:29], XYZ[:29])
    m = pc2.valid_mask(out)
    assert m[:29].all() and not m[29:].any()


def test_decode_big_endian():
    data = make_cloud(XYZ, 32, (0, 4, 8), is_bigendian=True)
    out = pc2.decode_xyz(data, len(XYZ), 32, (0, 4, 8), is_bigendian=True)
    np.testing.assert_array_equal(out[:29], XYZ[:29])


def test_decode_scan_nans_invalid_rows():
    data = make_cloud(XYZ, 16)
    pts, m = pc2.decode_scan(data, len(XYZ), 16)
    assert pts.dtype == np.float32 and m.dtype == bool
    assert not m[29:].any()
    assert np.isnan(pts[29:]).all()  # partial-NaN rows fully NaN'd
    np.testing.assert_array_equal(pts[:29], XYZ[:29])


def test_decode_errors():
    data = make_cloud(XYZ[:4], 16)
    with pytest.raises(ValueError):  # buffer shorter than n*point_step
        pc2.decode_xyz(data, 5, 16)
    with pytest.raises(ValueError):  # offset runs past the record
        pc2.decode_xyz(data, 4, 16, offsets=(0, 4, 14))


def test_field_offsets_from_msg_fields():
    fields = [
        SimpleNamespace(name="intensity", offset=12),
        SimpleNamespace(name="z", offset=8),
        SimpleNamespace(name="x", offset=0),
        SimpleNamespace(name="y", offset=4),
    ]
    assert pc2.field_offsets(fields) == (0, 4, 8)
    with pytest.raises(KeyError):
        pc2.field_offsets(fields[:2])


def test_convert_script_loads_standalone():
    """scripts/convert_bag.py must bootstrap the decoder WITHOUT importing
    the package (bare ROS hosts have no jax)."""
    path = os.path.join(REPO, "scripts", "convert_bag.py")
    spec = importlib.util.spec_from_file_location("_convert_bag", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # same decode through the script's entry point
    msg = SimpleNamespace(
        height=1, width=len(XYZ), point_step=32, is_bigendian=False,
        fields=[
            SimpleNamespace(name="x", offset=0),
            SimpleNamespace(name="y", offset=4),
            SimpleNamespace(name="z", offset=8),
        ],
    )
    out = mod._decode(make_cloud(XYZ, 32), msg)
    np.testing.assert_array_equal(out[:29], XYZ[:29])


def test_wrong_size_scan_skipping():
    """The H*W gate both converters apply (reference scans are fixed-size
    organized clouds; partial messages must be dropped, not reshaped)."""
    HW = 8
    good = make_cloud(XYZ[:HW], 16)
    pts, m = pc2.decode_scan(good, HW, 16)
    assert pts.shape == (HW, 3)
    # a 6-point message against HW=8 fails loudly at decode time
    with pytest.raises(ValueError):
        pc2.decode_xyz(make_cloud(XYZ[:6], 16), HW, 16)
