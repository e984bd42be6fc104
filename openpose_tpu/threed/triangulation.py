"""Multi-view 3D triangulation: vmapped DLT + Gauss-Newton Huber refinement.

JAX equivalent of PoseTriangulation
(src/openpose/3d/poseTriangulation.cpp:9-120,
poseTriangulationPrivate.cpp:119-281):

* keypoint validity: score > 0.35 and >= 8 px from the image border
  (poseTriangulation.cpp:9-26);
* min views: clamp(#cams - 1, 2, 4) unless overridden
  (poseTriangulation.cpp:96-99);
* DLT: nullspace of stacked rows [x*P3 - P1; y*P3 - P2] via SVD
  (poseTriangulationPrivate.cpp:119-155);
* nonlinear refine: the reference uses Ceres AutoDiff with Huber(2.0) on the
  reprojection *norm* residual (poseTriangulationPrivate.cpp:95-110,228-281);
  here: fixed-iteration Gauss-Newton with iteratively-reweighted Huber — same
  objective, jit/vmap-friendly control flow;
* outlier gate: mean reprojection error must stay under
  25 * sqrt(w*h / 1310720) px or the point is zeroed
  (poseTriangulation.cpp:98-120).

Everything is masked static-shape math: all parts x all views are computed,
invalid views carry zero weight.  vmap over keypoints, people, and (for the
multi-view pipeline) frames.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

VALID_SCORE_THRESHOLD = 0.35
BORDER_PX = 8.0
HUBER_DELTA = 2.0
REPROJECTION_MAX_BASE = 25.0  # * sqrt(area / 1310720)


def _dlt_solve(points2d: jax.Array, cams: jax.Array,
               mask: jax.Array) -> jax.Array:
    """One keypoint: points2d [V, 2], cams [V, 3, 4], mask [V] -> [4] homog.

    Masked views contribute zero rows (harmless to the nullspace solve).
    """
    x = points2d[:, 0:1]
    y = points2d[:, 1:2]
    rows_x = x * cams[:, 2, :] - cams[:, 0, :]     # [V, 4]
    rows_y = y * cams[:, 2, :] - cams[:, 1, :]
    a = jnp.concatenate([rows_x, rows_y], axis=0)  # [2V, 4]
    m2 = jnp.concatenate([mask, mask], axis=0)[:, None]
    a = a * m2
    # nullspace via eigh of A^T A (4x4; cheaper + stabler under vmap than SVD)
    ata = a.T @ a
    w, v = jnp.linalg.eigh(ata)
    sol = v[:, 0]
    w4 = jnp.where(jnp.abs(sol[3]) > 1e-12, sol[3], 1e-12)
    return sol / w4


def _reprojection(point3d: jax.Array, cams: jax.Array) -> jax.Array:
    """[4] homog point, [V, 3, 4] cams -> [V, 2] projected pixels."""
    proj = cams @ point3d                           # [V, 3]
    z = jnp.where(jnp.abs(proj[:, 2]) > 1e-9, proj[:, 2], 1e-9)
    return proj[:, :2] / z[:, None]


def _gauss_newton_refine(point3d: jax.Array, points2d: jax.Array,
                         cams: jax.Array, mask: jax.Array,
                         iterations: int = 10) -> jax.Array:
    """Minimize sum_v Huber(||proj_v - obs_v||) over the 3D point."""

    def body(_, p3):
        def residuals(xyz):
            p = jnp.concatenate([xyz, jnp.ones(1)])
            return (_reprojection(p, cams) - points2d).reshape(-1)  # [2V]

        xyz = p3[:3] / p3[3]
        r = residuals(xyz)
        jac = jax.jacfwd(residuals)(xyz)            # [2V, 3]
        # Huber IRLS weights on the per-view residual norm
        rn = jnp.sqrt(jnp.sum(r.reshape(-1, 2) ** 2, axis=-1) + 1e-12)
        wv = jnp.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn) * mask
        wr = jnp.repeat(wv, 2)
        jtj = (jac * wr[:, None]).T @ jac + 1e-9 * jnp.eye(3)
        jtr = (jac * wr[:, None]).T @ r
        delta = jnp.linalg.solve(jtj, jtr)
        xyz = xyz - delta
        return jnp.concatenate([xyz, jnp.ones(1)])

    return jax.lax.fori_loop(0, iterations, body, point3d)


@functools.partial(jax.jit, static_argnames=("min_views", "refine"))
def triangulate_points(points2d: jax.Array, scores: jax.Array,
                       cams: jax.Array, image_wh: jax.Array,
                       min_views: int = 0,
                       refine: bool = True) -> Tuple[jax.Array, jax.Array]:
    """Triangulate a set of keypoints from V views.

    points2d: [K, V, 2] pixel coords per keypoint per view.
    scores:   [K, V] detection scores.
    cams:     [V, 3, 4] camera matrices M = K [R|t].
    image_wh: [V, 2] image sizes (for border/outlier thresholds).

    Returns (xyzs [K, 4] = x, y, z, score; valid [K] bool).  Score is the
    mean 2D score over used views (Datum::poseKeypoints3D convention,
    include/openpose/core/datum.hpp:123-129 stores score in channel 3).
    """
    k, v = scores.shape
    n_cams = v
    mv = min_views if min_views > 0 else int(np.clip(n_cams - 1, 2, 4))

    valid_view = ((scores > VALID_SCORE_THRESHOLD)
                  & (points2d[..., 0] > BORDER_PX)
                  & (points2d[..., 0] < image_wh[None, :, 0] - BORDER_PX)
                  & (points2d[..., 1] > BORDER_PX)
                  & (points2d[..., 1] < image_wh[None, :, 1] - BORDER_PX))
    n_valid = valid_view.sum(axis=-1)               # [K]
    enough = n_valid >= mv

    def solve_one(p2, msk):
        mskf = msk.astype(jnp.float32)
        p = _dlt_solve(p2, cams, mskf)
        if refine:
            p = _gauss_newton_refine(p, p2, cams, mskf)
        err = jnp.sqrt(jnp.sum((_reprojection(p, cams) - p2) ** 2, axis=-1))
        mean_err = jnp.sum(err * mskf) / jnp.maximum(mskf.sum(), 1.0)
        return p, mean_err

    p3, err = jax.vmap(solve_one)(points2d, valid_view)

    # Outlier rejection (reprojection error vs resolution-scaled threshold)
    area = image_wh[0, 0] * image_wh[0, 1]
    max_err = REPROJECTION_MAX_BASE * jnp.sqrt(area.astype(jnp.float32)
                                               / 1310720.0)
    ok = enough & (err < max_err)
    mean_score = (jnp.sum(scores * valid_view, -1)
                  / jnp.maximum(valid_view.sum(-1), 1))
    xyzs = jnp.where(ok[:, None],
                     jnp.concatenate([p3[:, :3], mean_score[:, None]], -1),
                     0.0)
    return xyzs, ok


def reconstruct_array(keypoints_per_view, cam_matrices: np.ndarray,
                      image_sizes, min_views: int = 0) -> np.ndarray:
    """Host entry mirroring PoseTriangulation::reconstructArray.

    keypoints_per_view: list of [people, parts, 3] arrays (same people order
    across views — the reference makes the same assumption for its stereo
    rigs, poseTriangulation.cpp:138-147 uses min #people over views).
    Returns [people, parts, 4] (x, y, z, score).
    """
    views = [np.asarray(kv) for kv in keypoints_per_view]
    n_people = min((v.shape[0] for v in views if v.size), default=0)
    if n_people == 0:
        return np.zeros((0, 0, 4), np.float32)
    parts = next(v.shape[1] for v in views if v.size)
    v_count = len(views)
    pts = np.zeros((n_people, parts, v_count, 2), np.float32)
    scs = np.zeros((n_people, parts, v_count), np.float32)
    for i, kv in enumerate(views):
        if kv.size:
            pts[:, :, i, :] = kv[:n_people, :, :2]
            scs[:, :, i] = kv[:n_people, :, 2]
    wh = np.asarray(image_sizes, np.float32)
    out = np.zeros((n_people, parts, 4), np.float32)
    for person in range(n_people):
        xyzs, ok = triangulate_points(
            jnp.asarray(pts[person]), jnp.asarray(scs[person]),
            jnp.asarray(cam_matrices, jnp.float32), jnp.asarray(wh),
            min_views)
        out[person] = np.asarray(xyzs)
    return out
