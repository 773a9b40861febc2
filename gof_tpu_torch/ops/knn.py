"""Mean squared distance to the 3 nearest neighbours, for the initial
Gaussian scales (counterpart of gof_tpu/ops/knn.py; the exact scipy path
that init_from_points uses. The Morton-order device approximation waits)."""

from __future__ import annotations

import numpy as np


def mean_sq_dist_3nn_exact(points: np.ndarray) -> np.ndarray:
    """Exact mean squared 3-NN distance (host, scipy cKDTree)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=4)  # includes self at distance 0
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
