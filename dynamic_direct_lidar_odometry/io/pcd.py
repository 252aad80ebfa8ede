"""PCD file IO (host-side).

The equivalent of the reference's ``save_pcd`` service
(``src/odometry/map.cc:158-189`` -> ``pcl::io::savePCDFileBinary``) and
of PCL's loaders, without a PCL dependency: a minimal reader/writer for
PCD v0.7 with ``x y z`` (+ optional ``intensity``) fields, binary or
ASCII encoding — the format the reference's maps round-trip through.
"""

from __future__ import annotations

import numpy as np

_HEADER = """\
# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS {fields}
SIZE {sizes}
TYPE {types}
COUNT {counts}
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA {data}
"""


def save_pcd(
    path: str,
    points: np.ndarray,
    mask: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
    binary: bool = True,
) -> int:
    """Write valid points to ``path``. Returns the number written
    (the service's success/size response, map.cc:178-186).

    Plain binary xyz dumps go through the native C++ writer when the
    scanio runtime is built (map-sized clouds skip the Python row copy);
    intensity/ascii variants use the portable NumPy path."""
    if binary and intensity is None:
        from dynamic_direct_lidar_odometry.io import native

        if native.available():
            return native.save_pcd_native(path, points, mask)
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if mask is not None:
        m = np.asarray(mask, bool).reshape(-1)
        pts = pts[m]
        if intensity is not None:
            intensity = np.asarray(intensity, np.float32).reshape(-1)[m]
    cols = [pts]
    names = ["x", "y", "z"]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32).reshape(-1, 1))
        names.append("intensity")
    data = np.concatenate(cols, axis=1).astype("<f4")
    n = len(data)
    hdr = _HEADER.format(
        fields=" ".join(names),
        sizes=" ".join(["4"] * len(names)),
        types=" ".join(["F"] * len(names)),
        counts=" ".join(["1"] * len(names)),
        n=n,
        data="binary" if binary else "ascii",
    )
    with open(path, "wb") as f:
        f.write(hdr.encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")
    return n


def load_pcd(path: str):
    """Read a PCD v0.7 file with float32 scalar fields.

    Returns (points (N,3) float32, fields dict name->(N,) for any extra
    fields such as intensity).
    """
    with open(path, "rb") as f:
        header = {}
        field_names = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key] = rest
            if key == "FIELDS":
                field_names = rest.split()
            if key == "DATA":
                break
        n = int(header["POINTS"])
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(field_names))).split()]
        np_types = []
        for t, s, c in zip(types, sizes, counts):
            base = {"F": "f", "I": "i", "U": "u"}[t] + str(s)
            np_types.append(("<" + base, c))
        dtype = np.dtype(
            [
                (name, t, (c,)) if c > 1 else (name, t)
                for name, (t, c) in zip(field_names, np_types)
            ]
        )
        if header["DATA"] == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif header["DATA"] == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, ndmin=2)
            arr = np.zeros(n, dtype=dtype)
            col = 0
            for name, c in zip(field_names, counts):
                if c > 1:
                    arr[name] = raw[:, col:col + c]
                else:
                    arr[name] = raw[:, col]
                col += c
        else:
            raise ValueError(f"unsupported DATA {header['DATA']!r}")
    pts = np.stack(
        [arr["x"].astype(np.float32), arr["y"].astype(np.float32),
         arr["z"].astype(np.float32)], axis=1
    )
    extras = {
        name: np.asarray(arr[name])
        for name in field_names
        if name not in ("x", "y", "z")
    }
    return pts, extras
