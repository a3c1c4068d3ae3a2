"""Pareto-front + hypervolume utilities (Tables 3/4 methodology).

A copy of ``repro/core/pareto.py`` (the port imports nothing of the
reference package): float64 numpy, the same sweep order and the same
``inf``/0 cases.

All objectives are MINIMIZED (callers negate accuracy-like objectives).
Hypervolume: exact sweep for 2D, recursive slicing for 3D+, measured against
a reference point that must dominate-be-dominated-by nothing (worse than all
points in every objective).
"""
from __future__ import annotations

import numpy as np

__all__ = ["pareto_mask", "pareto_front", "hypervolume", "hypervolume_gain"]


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows (minimization)."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominates_i = np.all(pts <= pts[i], axis=1) & np.any(pts < pts[i], axis=1)
        if np.any(dominates_i):
            mask[i] = False
            continue
        dominated_by_i = np.all(pts >= pts[i], axis=1) & np.any(pts > pts[i], axis=1)
        mask &= ~dominated_by_i
        mask[i] = True
    return mask


def pareto_front(points: np.ndarray) -> np.ndarray:
    return np.asarray(points)[pareto_mask(points)]


def _hv(front: np.ndarray, ref: np.ndarray) -> float:
    """Recursive hypervolume (minimization, exact)."""
    front = front[np.all(front < ref, axis=1)]
    if front.shape[0] == 0:
        return 0.0
    if front.shape[1] == 1:
        return float(ref[0] - front[:, 0].min())
    # Sort by first objective; sweep slices.
    order = np.argsort(front[:, 0])
    front = front[order]
    vol = 0.0
    prev = ref[0]
    # iterate from worst (largest) first objective to best
    for i in range(front.shape[0] - 1, -1, -1):
        x = front[i, 0]
        width = prev - x
        if width > 0:
            sub = front[: i + 1, 1:]
            vol += width * _hv(sub, ref[1:])
            prev = x
    return float(vol)


def hypervolume(points: np.ndarray, ref: np.ndarray) -> float:
    pts = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if pts.size == 0:
        return 0.0
    return _hv(pareto_front(pts), ref)


def hypervolume_gain(base_points: np.ndarray, extra_points: np.ndarray, ref: np.ndarray) -> float:
    """% increase in hypervolume from adding ``extra_points`` (paper metric)."""
    base = hypervolume(base_points, ref)
    both = hypervolume(np.concatenate([np.asarray(base_points), np.asarray(extra_points)]), ref)
    if base <= 0:
        return float("inf") if both > 0 else 0.0
    return 100.0 * (both - base) / base
