"""Distributed bundle adjustment: joint 3D points + camera refinement.

Extends the per-point triangulation (threed/triangulation.py, the reference's
Ceres-refine equivalent) to the full multi-view bundle problem the north star
asks for: minimize the robust reprojection error over all 3D keypoints AND
the camera extrinsics simultaneously,

    min_{X, c}  sum_{p, v}  Huber(|| proj(K_v [R(c_v) | t(c_v)] X_p) - obs ||)

solved by Gauss-Newton with the classic **Schur complement**: the per-point
3x3 Hessian blocks are eliminated analytically, leaving a small reduced
camera system.  Device mapping:

* points shard over the mesh `data` axis (`shard_map`);
* each shard accumulates its contribution to the reduced camera Hessian/rhs;
* one `psum` over the data axis assembles the global reduced system — the
  only cross-device communication per iteration;
* the dense reduced solve (6V x 6V, V = #cameras, small) is replicated.

Cameras are parameterized as se(3) twists around the initial extrinsics
(axis-angle rotation + translation); the first camera is held fixed (gauge).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HUBER_DELTA = 2.0


def _rodrigues(w: jax.Array) -> jax.Array:
    """Axis-angle [3] -> rotation matrix [3, 3] (stable near 0)."""
    theta = jnp.sqrt(jnp.sum(w * w) + 1e-12)
    k = w / theta
    kx = jnp.array([[0.0, -k[2], k[1]],
                    [k[2], 0.0, -k[0]],
                    [-k[1], k[0], 0.0]])
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    r = jnp.eye(3) + s * kx + (1.0 - c) * (kx @ kx)
    # theta ~ 0: first-order fallback
    small = theta < 1e-6
    r0 = jnp.eye(3) + kx * theta
    return jnp.where(small, r0, r)


def _camera_matrix(intrinsics: jax.Array, extrinsics0: jax.Array,
                   twist: jax.Array) -> jax.Array:
    """K [3,3], base [R0|t0] [3,4], twist [6] -> refined M = K [R|t]."""
    delta_r = _rodrigues(twist[:3])
    r = delta_r @ extrinsics0[:, :3]
    t = delta_r @ extrinsics0[:, 3] + twist[3:]
    return intrinsics @ jnp.concatenate([r, t[:, None]], axis=1)


def _point_residuals(point: jax.Array, cams: jax.Array, obs: jax.Array,
                     mask: jax.Array):
    """point [3]; cams [V,3,4]; obs [V,2] -> (residuals [2V], weights [2V])."""
    ph = jnp.concatenate([point, jnp.ones(1)])
    proj = cams @ ph                                  # [V, 3]
    z = jnp.where(jnp.abs(proj[:, 2]) > 1e-9, proj[:, 2], 1e-9)
    r = (proj[:, :2] / z[:, None] - obs).reshape(-1)  # [2V]
    rn = jnp.sqrt(jnp.sum(r.reshape(-1, 2) ** 2, -1) + 1e-12)
    wv = jnp.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn) * mask
    # IRLS: weights are constants w.r.t. the optimization variables —
    # differentiating through them biases the GN step (observed ~2x
    # overshoot), so cut the gradient here.
    return r, jax.lax.stop_gradient(jnp.repeat(wv, 2))


def _build_normal_eqs(points, twists, intrinsics, extrinsics0, obs, mask):
    """Per-shard reduced camera system via Schur complement.

    points [Ps,3]; obs [Ps,V,2]; mask [Ps,V]; twists [V,6].
    Returns (h_cc [6V,6V], b_c [6V], delta_points fn inputs (hpp_inv, hpc,
    b_p) per point) aggregated over this shard's points.
    """
    v = twists.shape[0]

    def cams_of(tw):
        return jax.vmap(_camera_matrix)(intrinsics, extrinsics0, tw)

    def per_point(point, ob, mk):
        def resid(pt, tw_flat):
            cams = cams_of(tw_flat.reshape(v, 6))
            r, w = _point_residuals(pt, cams, ob, mk)
            return r * jnp.sqrt(w)

        tw_flat = twists.reshape(-1)
        r = resid(point, tw_flat)
        jp = jax.jacfwd(resid, argnums=0)(point, tw_flat)     # [2V, 3]
        jc = jax.jacfwd(resid, argnums=1)(point, tw_flat)     # [2V, 6V]
        hpp = jp.T @ jp + 1e-6 * jnp.eye(3)
        hpc = jp.T @ jc                                       # [3, 6V]
        hcc = jc.T @ jc                                       # [6V, 6V]
        bp = jp.T @ r
        bc = jc.T @ r
        hpp_inv = jnp.linalg.inv(hpp)
        # Schur: reduced camera system contribution
        h_red = hcc - hpc.T @ hpp_inv @ hpc
        b_red = bc - hpc.T @ hpp_inv @ bp
        return h_red, b_red, hpp_inv, hpc, bp

    h_red, b_red, hpp_inv, hpc, bp = jax.vmap(per_point)(points, obs, mask)
    return (h_red.sum(0), b_red.sum(0), hpp_inv, hpc, bp)


def bundle_adjust(points3d: np.ndarray, observations: np.ndarray,
                  vis_mask: np.ndarray, intrinsics: np.ndarray,
                  extrinsics0: np.ndarray, iterations: int = 10,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Refine points and camera extrinsics.

    points3d [N,3]; observations [N,V,2] pixels; vis_mask [N,V];
    intrinsics [V,3,3]; extrinsics0 [V,3,4].
    Returns (refined points [N,3], refined extrinsics [V,3,4]).
    When `mesh` is given, points shard over its 'data' axis and the reduced
    camera system is psum-assembled across devices.
    """
    n, v = vis_mask.shape
    pts = jnp.asarray(points3d, jnp.float32)
    obs = jnp.asarray(observations, jnp.float32)
    msk = jnp.asarray(vis_mask, jnp.float32)
    kk = jnp.asarray(intrinsics, jnp.float32)
    e0 = jnp.asarray(extrinsics0, jnp.float32)

    def total_cost(pts_, twists_):
        cams = jax.vmap(_camera_matrix)(kk, e0, twists_)

        def one(pt, ob, mk):
            r, w = _point_residuals(pt, cams, ob, mk)
            return jnp.sum(w * r * r)

        return jax.vmap(one)(pts_, obs, msk).sum()

    def iteration(carry, _):
        # Levenberg-Marquardt: damped step, accept only if the cost drops
        # (Ceres' default trust-region behavior, which the reference relies
        # on — pure GN overshoots through the rotation nonlinearity).
        pts, twists, lam, cost = carry

        def shard_fn(p_shard, o_shard, m_shard):
            h, b, hpp_inv, hpc, bp = _build_normal_eqs(
                p_shard, twists, kk, e0, o_shard, m_shard)
            if mesh is not None:
                h = jax.lax.psum(h, "data")
                b = jax.lax.psum(b, "data")
            return h, b, hpp_inv, hpc, bp

        if mesh is not None:
            h, b, hpp_inv, hpc, bp = jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=(P("data"), P("data"), P("data")),
                out_specs=(P(), P(), P("data"), P("data"), P("data")),
            )(pts, obs, msk)
        else:
            h, b, hpp_inv, hpc, bp = shard_fn(pts, obs, msk)

        # Gauge fix: freeze camera 0 (zero out its block); LM damping
        fix = jnp.zeros((v, 6)).at[1:].set(1.0).reshape(-1)
        h = h * fix[:, None] * fix[None, :] + jnp.diag(1.0 - fix)
        h = h + lam * jnp.diag(jnp.maximum(jnp.diag(h), 1e-6))
        b = b * fix
        delta_c = -jnp.linalg.solve(h, b)
        # Back-substitute per-point updates (same damping on point blocks)
        delta_p = -jax.vmap(
            lambda hi, hp, bpp: jnp.linalg.solve(
                jnp.linalg.inv(hi) * (1.0 + lam), bpp + hp @ delta_c)
        )(hpp_inv, hpc, bp)
        new_pts = pts + delta_p
        new_twists = twists + delta_c.reshape(v, 6)
        new_cost = total_cost(new_pts, new_twists)
        accept = new_cost < cost
        pts = jnp.where(accept, new_pts, pts)
        twists = jnp.where(accept, new_twists, twists)
        lam = jnp.where(accept, lam / 3.0, lam * 10.0)
        cost = jnp.where(accept, new_cost, cost)
        return (pts, twists, lam, cost), None

    twists0 = jnp.zeros((v, 6))
    init = (pts, twists0, jnp.float32(1e-3), total_cost(pts, twists0))
    (pts_out, twists_out, _, _), _ = jax.lax.scan(
        iteration, init, None, length=iterations)

    refined_ext = np.stack([
        np.asarray(_camera_matrix(jnp.eye(3), e0[i], twists_out[i]))
        for i in range(v)])
    return np.asarray(pts_out), refined_ext
