#!/usr/bin/env python3
"""Convert a reference rosbag to the framework's ScanSequence .npz.

Standalone — runs on a ROS host (or anywhere the pure-python ``rosbags``
package is installed) WITHOUT importing jax or the framework, so it can
live next to the bags. Produces the exact format
``dynamic_direct_lidar_odometry.io.dataset.ScanSequence`` loads:

  points: (S, H*W, 3) f32 sensor-frame, NaN for no-return
  mask:   (S, H*W)    bool
  stamps: (S,)        f64 seconds
  H, W:   ()          int
  imu_accel: (N, 3)   optional — startup IMU buffer for gravity
                      alignment (odom.cc:534-597 buffers 1000 samples)

Usage (DOALS, 64x2048; topics per launch/play_DOALS_data.launch):

  python scripts/convert_bag.py small_town_simulation.bag \
      --topic /os1_cloud_node/points --rows 64 --cols 2048 \
      --imu-topic /os1_cloud_node/imu --out doals_small_town.npz

Backends tried in order: ``rosbags`` (pip install rosbags), then the
ROS1 ``rosbag`` python API.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np


def _load_pc2():
    """Load the shared PointCloud2 decoder WITHOUT importing the package
    (whose __init__ pulls in jax — not available on a bare ROS host).
    The module itself is numpy-only."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "dynamic_direct_lidar_odometry", "io", "pointcloud2.py",
    )
    spec = importlib.util.spec_from_file_location("_ddlo_pc2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pc2 = _load_pc2()


def _decode(msg_data: bytes, msg) -> np.ndarray:
    return pc2.decode_xyz(
        msg_data,
        msg.height * msg.width,
        msg.point_step,
        offsets=pc2.field_offsets(msg.fields),
        is_bigendian=bool(getattr(msg, "is_bigendian", False)),
    )


def _read_with_rosbags(bag, topic, imu_topic):
    from rosbags.highlevel import AnyReader
    import pathlib

    clouds, stamps, imu = [], [], []
    with AnyReader([pathlib.Path(bag)]) as reader:
        conns = [c for c in reader.connections if c.topic in (topic, imu_topic)]
        for conn, ts, raw in reader.messages(connections=conns):
            msg = reader.deserialize(raw, conn.msgtype)
            if conn.topic == topic:
                clouds.append(_decode(bytes(msg.data), msg))
                stamps.append(ts * 1e-9)
            elif imu_topic and conn.topic == imu_topic:
                a = msg.linear_acceleration
                imu.append((a.x, a.y, a.z))
    return clouds, stamps, imu


def _read_with_rosbag1(bag, topic, imu_topic):
    import rosbag  # ROS1 host

    clouds, stamps, imu = [], [], []
    topics = [topic] + ([imu_topic] if imu_topic else [])
    with rosbag.Bag(bag) as b:
        for top, msg, t in b.read_messages(topics=topics):
            if top == topic:
                clouds.append(_decode(msg.data, msg))
                stamps.append(msg.header.stamp.to_sec())
            else:
                a = msg.linear_acceleration
                imu.append((a.x, a.y, a.z))
    return clouds, stamps, imu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("--topic", required=True,
                    help="PointCloud2 topic (launch remaps it to "
                         "'pointcloud', launch/DOALS.launch:4-7)")
    ap.add_argument("--rows", type=int, required=True)
    ap.add_argument("--cols", type=int, required=True)
    ap.add_argument("--imu-topic", default=None,
                    help="buffer startup IMU for gravity alignment")
    ap.add_argument("--imu-samples", type=int, default=1000)
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)

    errors = []
    for reader in (_read_with_rosbags, _read_with_rosbag1):
        try:
            clouds, stamps, imu = reader(args.bag, args.topic, args.imu_topic)
            break
        except ImportError as e:
            errors.append(str(e))
    else:
        print(
            "no rosbag backend available (pip install rosbags, or run on "
            f"a ROS1 host): {errors}", file=sys.stderr,
        )
        return 1

    HW = args.rows * args.cols
    pts_all, mask_all, kept_stamps = [], [], []
    skipped = 0
    for xyz, ts in zip(clouds, stamps):
        if len(xyz) != HW:
            skipped += 1
            continue
        m = pc2.valid_mask(xyz)
        pts_all.append(np.where(m[:, None], xyz, np.nan).astype(np.float32))
        mask_all.append(m)
        kept_stamps.append(ts)
    if not pts_all:
        print("no scans matched rows*cols; check --rows/--cols",
              file=sys.stderr)
        return 1

    data = dict(
        points=np.stack(pts_all),
        mask=np.stack(mask_all),
        stamps=np.asarray(kept_stamps, np.float64),
        H=args.rows,
        W=args.cols,
    )
    if imu:
        data["imu_accel"] = np.asarray(
            imu[: args.imu_samples], np.float32
        )
    np.savez_compressed(args.out, **data)
    print(
        f"wrote {args.out}: {len(pts_all)} scans "
        f"({args.rows}x{args.cols}), {skipped} skipped, "
        f"{len(imu)} imu samples"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
