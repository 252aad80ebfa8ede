"""Byte-format parity of evaluation dumps vs the reference
(DetectionModule::setupEvaluation/evaluate, detection.cpp:910-954).

Expected strings below are generated from the C++ code shape: Eigen's
default ``operator<<`` (IO.h print_matrix: %g-style 6-significant-digit
entries, right-padded to the max entry width, single-space separated),
``pose_file << stamp.toNSec() << endl << T_ << ";" << endl`` and
``indices_file << i << "\n"`` per dynamic index into ``%04d.txt``.
"""

import os

import numpy as np

from dynamic_direct_lidar_odometry.utils import evaldump


def test_eigen_matrix_str_identity():
    # all entries width 1 -> plain single-space separation
    s = evaldump.eigen_matrix_str(np.eye(4, dtype=np.float32))
    assert s == "1 0 0 0\n0 1 0 0\n0 0 1 0\n0 0 0 1"


def test_eigen_matrix_str_alignment():
    # Eigen pads every entry to the global max width, right-justified
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.5
    T[1, 3] = -12.25
    s = evaldump.eigen_matrix_str(T)
    # widest entry "-12.25" = 6 chars
    assert s.splitlines() == [
        "     1      0      0    0.5",
        "     0      1      0 -12.25",
        "     0      0      1      0",
        "     0      0      0      1",
    ]


def test_eigen_matrix_str_six_sig_digits():
    # ostream default precision: 6 significant digits, %g trimming
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 1.23456789
    T[1, 3] = 1000000.0
    s = evaldump.eigen_matrix_str(T)
    assert "1.23457" in s  # rounded to 6 sig digits
    assert "1e+06" in s  # %g switches to exponent form


def test_evaldump_session_files(tmp_path):
    cfg_src = os.path.join(tmp_path, "my_cfg.yaml")
    with open(cfg_src, "w") as f:
        f.write("odomNode:\n  gicp:\n    minNumPoints: 10\n")
    dump = evaldump.EvalDump(str(tmp_path), cfg_src)
    # timestamped dir name: YYYY_MM_DD-HH_MM_SS (put_time format)
    name = os.path.basename(dump.output_dir)
    assert len(name) == 19 and name[4] == "_" and name[10] == "-"
    # cfg.yaml copied byte-identical
    with open(os.path.join(dump.output_dir, "cfg.yaml")) as f:
        assert f.read() == "odomNode:\n  gicp:\n    minNumPoints: 10\n"

    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.5, -2.0, 0.25]
    dump.frame(7, [3, 9, 42], 123.456789, T)
    # %04d.txt with one index per line (detection.cpp:938-949)
    with open(os.path.join(dump.output_dir, "0007.txt")) as f:
        assert f.read() == "3\n9\n42\n"
    # poses.txt: nsec, newline, eigen matrix, ";" (detection.cpp:952)
    with open(os.path.join(dump.output_dir, "poses.txt")) as f:
        txt = f.read()
    nsec_line, rest = txt.split("\n", 1)
    assert nsec_line == str(int(round(123.456789 * 1e9)))
    assert rest == evaldump.eigen_matrix_str(T) + ";\n"

    # appending a second frame to the same seq accumulates (ios::app)
    dump.frame(7, [1], 124.0, T)
    with open(os.path.join(dump.output_dir, "0007.txt")) as f:
        assert f.read() == "3\n9\n42\n1\n"
