"""Point cloud with colors and weights, and a PLY writer and reader, in numpy
(counterpart of ``bpvo_tpu/vo/point_cloud.py``; reference
point_cloud.{h,cc})."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointCloud:
    """points (N, 3) float32, colors (N, 4) uint8 rgba, weights (N,) float32,
    pose (4, 4): world pose of the originating keyframe."""
    points: np.ndarray
    colors: np.ndarray
    weights: np.ndarray
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))

    def __len__(self):
        return len(self.points)

    def filtered(self, min_weight: float = 0.0, max_depth: float = np.inf):
        """Subset by weight and depth (reference apps/vo_app.cc:258-274)."""
        m = (self.weights >= min_weight) & (self.points[:, 2] <= max_depth)
        return PointCloud(self.points[m], self.colors[m], self.weights[m],
                          self.pose)

    def transformed(self) -> np.ndarray:
        """The points mapped into the world frame by the cloud's pose."""
        return self.points @ self.pose[:3, :3].T + self.pose[:3, 3]


_VERTEX = [("xyz", "<f4", 3), ("rgb", "u1", 3)]


def write_ply(filename: str, cloud: PointCloud, binary: bool = True) -> None:
    """PLY with x y z r g b in the world frame (reference
    point_cloud.cc:140+)."""
    n = len(cloud)
    pts = cloud.transformed().astype("<f4")
    rgb = cloud.colors[:, :3].astype(np.uint8)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    if binary:
        rec = np.zeros(n, dtype=_VERTEX)
        rec["xyz"] = pts
        rec["rgb"] = rgb
        with open(filename, "wb") as f:
            f.write(header.encode("ascii"))
            rec.tofile(f)
    else:
        with open(filename, "w") as f:
            f.write(header)
            for p, c in zip(pts, rgb):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def read_ply(filename: str) -> PointCloud:
    """Reader for the files ``write_ply`` writes (points in the world
    frame, identity pose, unit weights)."""
    with open(filename, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{filename}: no PLY end_header")
            header += line
        lines = header.decode("ascii").splitlines()
        n = next(int(l.split()[-1]) for l in lines
                 if l.startswith("element vertex"))
        if any("binary_little_endian" in l for l in lines):
            rec = np.fromfile(f, dtype=_VERTEX, count=n)
            pts, rgb = rec["xyz"], rec["rgb"]
        else:
            data = np.loadtxt(f, max_rows=n).reshape(n, 6)
            pts, rgb = data[:, :3].astype(np.float32), data[:, 3:].astype(
                np.uint8)
    colors = np.concatenate([rgb, np.full((n, 1), 255, np.uint8)], axis=1)
    return PointCloud(pts, colors, np.ones(n, np.float32))
