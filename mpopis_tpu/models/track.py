"""Track geometry: CSV centerline loading, boundary offsets, and the
point-to-centerline distance query.

Reference semantics: car_racing_tracks.jl — `Track(csv; width, sample_factor)`
(:14-34), `calculate_boundary` (:36-62), `within_track` (:64-92). The query
(nearest subsampled centerline point → better neighbor → segment projection →
perpendicular distance vs lane width) maps to a fixed-size argmin + gather,
which vmaps over K×T rollout positions and folds into the Pallas rollout
kernel, which reads the subsampled track from global memory.

The `distance_query` is jit-safe (static M) and is the single hot geometry
op: every reward evaluation of every rollout step calls it once per car.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np

_TRACK_DIR = os.path.join(os.path.dirname(__file__), "tracks")


def track_path(name: str) -> str:
    """Resolve a bundled track name ('curve', 'cubic3', ...) to its CSV."""
    if os.path.sep in name or name.endswith(".csv"):
        return name
    return os.path.join(_TRACK_DIR, name + ".csv")


def _compute_boundaries(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Offset the centerline along central-difference normals (ref :36-62)."""
    n = len(x)
    left = np.zeros((n, 2))
    right = np.zeros((n, 2))
    for i in range(n):
        lo = max(i - 1, 0)
        hi = min(i + 1, n - 1)
        if i == 0:
            dx, dy = x[1] - x[0], y[1] - y[0]
        elif i == n - 1:
            dx, dy = x[-1] - x[-2], y[-1] - y[-2]
        else:
            dx, dy = x[hi] - x[lo], y[hi] - y[lo]
        p = np.array([-dy, dx])
        p = p / np.linalg.norm(p)
        c = np.array([x[i], y[i]])
        left[i] = c + w[i] * p
        right[i] = c - w[i] * p
    return left, right


@dataclasses.dataclass(frozen=True, eq=False)
class Track:
    """Immutable track: full-resolution centerline for plotting, subsampled
    centerline for fast distance queries."""

    x: np.ndarray
    y: np.ndarray
    lane_width: np.ndarray
    xs: np.ndarray  # subsampled
    ys: np.ndarray
    lane_width_s: np.ndarray
    boundary_left: np.ndarray
    boundary_right: np.ndarray
    sample_factor: int

    @staticmethod
    def load(
        name_or_path: str = "curve",
        width: float | np.ndarray = 15.0,
        sample_factor: int = 20,
    ) -> "Track":
        path = track_path(name_or_path)
        data = np.loadtxt(path, delimiter=",")
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError("track CSV must have exactly 2 columns")
        x, y = data[:, 0], data[:, 1]
        if np.isscalar(width) or np.ndim(width) == 0:
            w = np.full(len(x), float(width))
        else:
            w = np.asarray(width, dtype=float)
            if len(w) != len(x):
                raise ValueError("width vector length must match track length")
        left, right = _compute_boundaries(x, y, w)
        return Track(
            x=x,
            y=y,
            lane_width=w,
            xs=x[::sample_factor],
            ys=y[::sample_factor],
            lane_width_s=w[::sample_factor],
            boundary_left=left,
            boundary_right=right,
            sample_factor=sample_factor,
        )

    def query_arrays(self, dtype=jnp.float32):
        """Device arrays for the distance query: (pts (M,2), widths (M,))."""
        pts = jnp.asarray(np.stack([self.xs, self.ys], axis=1), dtype=dtype)
        widths = jnp.asarray(self.lane_width_s, dtype=dtype)
        return pts, widths


def distance_query(pts: jnp.ndarray, widths: jnp.ndarray, pos: jnp.ndarray):
    """Distance from `pos` (2,) to the centerline polyline; ref :64-92.

    Returns (within: bool, dist: scalar). `pts` is the (M,2) subsampled
    centerline, `widths` the (M,) lane half-widths. The reference compares
    against the lane width at the *nearest point's* index (not the segment),
    which is reproduced exactly.
    """
    m = pts.shape[0]
    d = pts - pos[None, :]
    d2 = jnp.sum(d * d, axis=1)
    i = jnp.argmin(d2)
    im1 = jnp.mod(i - 1, m)
    ip1 = jnp.mod(i + 1, m)
    dist_m1 = jnp.sqrt(jnp.sum((pts[im1] - pos) ** 2))
    dist_p1 = jnp.sqrt(jnp.sum((pts[ip1] - pos) ** 2))
    i2 = jnp.where(dist_m1 <= dist_p1, im1, ip1)
    p1 = pts[i]
    p2 = pts[i2]
    seg = p2 - p1
    t = jnp.dot(pos - p1, seg) / jnp.dot(seg, seg)
    proj = p1 + t * seg
    dist = jnp.sqrt(jnp.sum((proj - pos) ** 2))
    return dist < widths[i], dist
