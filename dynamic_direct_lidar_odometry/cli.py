"""Command-line interface: run / convert / benchmark.

The thin-CLI replacement for the reference's roslaunch surface
(``launch/ddlo.launch``, ``launch/DOALS.launch``): one process, explicit
dataset in, artifacts out (TUM trajectory, object trajectories, map PCD,
per-stage timing dashboard, optional evaluation dumps + checkpoints).

  python -m dynamic_direct_lidar_odometry.cli run \
      --dataset seq.npz --config cfg/DOALS.yaml --out results/

  python -m dynamic_direct_lidar_odometry.cli synth \
      --scans 40 --out seq.npz

  python -m dynamic_direct_lidar_odometry.cli convert \
      --bag kantplatz.bag --topic /points --rows 512 --cols 512 --out seq.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _cmd_run(args: argparse.Namespace) -> int:
    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry import runner
    from dynamic_direct_lidar_odometry.io.dataset import ScanSequence

    seq = ScanSequence.load(args.dataset)
    if args.config:
        cfg = cfg_lib.load_config(args.config)
    else:
        cfg = cfg_lib.doals_config()
        # the DOALS preset assumes a 2048-column scan (cfg/DOALS.yaml:
        # downsampling col=10, keyframe threshD=5); scale both to the
        # dataset's actual geometry so the preset stays usable as the
        # no-config default
        col = max(1, seq.W // 256)
        cfg = dataclasses.replace(
            cfg,
            preprocessing=dataclasses.replace(
                cfg.preprocessing,
                downsampling=dataclasses.replace(
                    cfg.preprocessing.downsampling, col=col
                ),
            ),
            keyframe=dataclasses.replace(
                cfg.keyframe, thresh_dist=1.0
            ),
        )
    cfg = dataclasses.replace(
        cfg,
        dynamic_detection=not args.no_dynamic,
        detection=dataclasses.replace(
            cfg.detection, rows=seq.H, columns=seq.W
        ),
        capacity=cfg_lib.capacity_for_scan(seq.H, seq.W),
    )
    res = runner.replay(
        cfg,
        seq,
        out_dir=args.out,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        evaluate=args.evaluate,
        progress=not args.quiet,
        dashboard_every=args.dashboard_every,
        viz_every=args.viz_every,
        save_every=args.save_every,
        export_clouds_every=args.export_clouds_every,
    )
    print(res.profiler.dashboard())
    print(
        f"scans={len(res.poses)} keyframes={res.num_keyframes} "
        f"map_points={res.map_points}"
    )
    if seq.gt_poses is not None:
        ate = runner.ate_rmse(
            res.poses, seq.gt_poses,
            est_stamps=res.stamps, gt_stamps=seq.stamps,
        )
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
    return 0


def _cmd_synth(args: argparse.Namespace) -> int:
    from dynamic_direct_lidar_odometry.io import dataset

    seq = dataset.synthetic_sequence(
        n_scans=args.scans, H=args.rows, W=args.cols,
        n_dynamic=args.dynamic, seed=args.seed,
    )
    seq.save(args.out)
    print(f"wrote {args.out}: {len(seq)} scans of {seq.H}x{seq.W}")
    return 0


def _cmd_convert(args: argparse.Namespace) -> int:
    from dynamic_direct_lidar_odometry.io import dataset

    dataset.convert_rosbag(
        args.bag, args.topic, args.rows, args.cols, args.out
    )
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ddlo")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="replay a dataset through the pipeline")
    run.add_argument("--dataset", required=True)
    run.add_argument("--config", default=None,
                     help="reference-format YAML (cfg/ddlo.yaml style)")
    run.add_argument("--out", default=None)
    run.add_argument("--no-dynamic", action="store_true",
                     help="plain DLO (dynamicDetection=false)")
    run.add_argument("--evaluate", action="store_true",
                     help="dump per-frame dynamic indices "
                          "(detection.cpp:936-954 format)")
    run.add_argument("--checkpoint-every", type=int, default=0)
    run.add_argument("--resume", default=None)
    run.add_argument("--quiet", action="store_true")
    run.add_argument("--dashboard-every", type=int, default=0,
                     help="print the debug dashboard every N scans "
                          "(odom.cc:1317-1461)")
    run.add_argument("--save-every", type=int, default=0,
                     help="periodic map+trajectory snapshot every N scans "
                          "(SIGUSR1 requests one on demand)")
    run.add_argument("--export-clouds-every", type=int, default=0,
                     help="export per-stage intermediate clouds (residual/"
                          "static/keyframes PCDs) every N scans")
    run.add_argument("--viz-every", type=int, default=0,
                     help="write range/residual/label debug images every "
                          "N scans (detection.cpp:834-909)")
    run.set_defaults(fn=_cmd_run)

    synth = sub.add_parser("synth", help="generate a synthetic sequence")
    synth.add_argument("--scans", type=int, default=40)
    synth.add_argument("--rows", type=int, default=64)
    synth.add_argument("--cols", type=int, default=1024)
    synth.add_argument("--dynamic", type=int, default=2)
    synth.add_argument("--seed", type=int, default=0)
    synth.add_argument("--out", required=True)
    synth.set_defaults(fn=_cmd_synth)

    conv = sub.add_parser("convert", help="convert a rosbag")
    conv.add_argument("--bag", required=True)
    conv.add_argument("--topic", required=True)
    conv.add_argument("--rows", type=int, required=True)
    conv.add_argument("--cols", type=int, required=True)
    conv.add_argument("--out", required=True)
    conv.set_defaults(fn=_cmd_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
