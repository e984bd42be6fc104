"""Pyramidal Lucas-Kanade optical flow in JAX (device-friendly, static shapes).

JAX replacement for the reference's hand-rolled CPU/CUDA pyramidal LK
(src/openpose/tracking/pyramidalLK.{cpp,cu}: 3-level pyramid, 21x21 patches,
2x2 normal-equation solve per keypoint).  Differences by design:

* the pyramid is built with a separable 5-tap Gaussian (cv::pyrDown kernel);
* all keypoints are solved in parallel (vmap) with a fixed iteration count
  (lax.fori_loop) instead of per-point early exit — identical update rule,
  XLA-friendly control flow;
* patches are gathered with bilinear interpolation like the reference's
  `getPatch` path.

Status semantics: a point is invalid (status=1) if its patch leaves the frame
at any level, mirroring OUT_OF_FRAME in pyramidalLK.cpp:27-30.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PYRDOWN_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _pyr_down(img: jax.Array) -> jax.Array:
    """cv::pyrDown: 5-tap Gaussian blur + 2x decimation (reflect border)."""
    k = jnp.asarray(_PYRDOWN_K)
    pad = jnp.pad(img, ((2, 2), (0, 0)), mode="reflect")
    img = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"),
                   in_axes=1, out_axes=1)(pad)
    pad = jnp.pad(img, ((0, 0), (2, 2)), mode="reflect")
    img = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(pad)
    return img[::2, ::2]


def build_pyramid(image: jax.Array, levels: int = 3) -> Tuple[jax.Array, ...]:
    """Gray float image [H, W] -> tuple of `levels` images (finest first)."""
    pyr = [image]
    for _ in range(levels - 1):
        pyr.append(_pyr_down(pyr[-1]))
    return tuple(pyr)


def _bilinear_patch(img: jax.Array, cx: jax.Array, cy: jax.Array,
                    patch: int) -> jax.Array:
    """Sample a (patch x patch) window centered at (cx, cy), bilinear."""
    h, w = img.shape
    half = (patch - 1) / 2.0
    offs = jnp.arange(patch, dtype=jnp.float32) - half
    xs = cx + offs[None, :]
    ys = cy + offs[:, None]
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    dx = xs - x0
    dy = ys - y0

    def tap(yy, xx):
        xi = jnp.clip(xx, 0, w - 1).astype(jnp.int32)
        yi = jnp.clip(yy, 0, h - 1).astype(jnp.int32)
        return img[yi, xi]

    return (tap(y0, x0) * (1 - dx) * (1 - dy) + tap(y0, x0 + 1) * dx * (1 - dy)
            + tap(y0 + 1, x0) * (1 - dx) * dy + tap(y0 + 1, x0 + 1) * dx * dy)


def _lk_level(prev_img, next_img, pt_prev, guess, patch, iterations):
    """One pyramid level for one point: returns (flow, ok)."""
    h, w = prev_img.shape
    template = _bilinear_patch(prev_img, pt_prev[0], pt_prev[1], patch)
    # Scharr-style central-difference gradients of the template window
    ix = (_bilinear_patch(prev_img, pt_prev[0] + 1, pt_prev[1], patch)
          - _bilinear_patch(prev_img, pt_prev[0] - 1, pt_prev[1], patch)) * 0.5
    iy = (_bilinear_patch(prev_img, pt_prev[0], pt_prev[1] + 1, patch)
          - _bilinear_patch(prev_img, pt_prev[0], pt_prev[1] - 1, patch)) * 0.5
    sxx = jnp.sum(ix * ix)
    syy = jnp.sum(iy * iy)
    sxy = jnp.sum(ix * iy)
    det = sxx * syy - sxy * sxy
    ok_grad = det > 1e-6
    inv = jnp.where(ok_grad, 1.0 / jnp.where(ok_grad, det, 1.0), 0.0)

    def body(_, flow):
        cur = _bilinear_patch(next_img, pt_prev[0] + flow[0],
                              pt_prev[1] + flow[1], patch)
        it = cur - template
        bx = jnp.sum(ix * it)
        by = jnp.sum(iy * it)
        dx = -(syy * bx - sxy * by) * inv
        dy = -(sxx * by - sxy * bx) * inv
        return flow + jnp.array([dx, dy])

    flow = jax.lax.fori_loop(0, iterations, body, guess)
    return flow, ok_grad


def _inside(pt, flow, shape, patch):
    """Finest-level bounds check (OUT_OF_FRAME, pyramidalLK.cpp:27-30);
    coarse levels rely on clamped sampling like cv::BORDER_REPLICATE."""
    h, w = shape
    half = (patch - 1) / 2.0
    end_x = pt[0] + flow[0]
    end_y = pt[1] + flow[1]
    return ((pt[0] - half >= 0) & (pt[0] + half < w)
            & (pt[1] - half >= 0) & (pt[1] + half < h)
            & (end_x >= 0) & (end_x < w) & (end_y >= 0) & (end_y < h))


@functools.partial(jax.jit, static_argnames=("levels", "patch", "iterations"))
def pyramidal_lk(prev_gray: jax.Array, next_gray: jax.Array,
                 points: jax.Array, levels: int = 3, patch: int = 21,
                 iterations: int = 5) -> Tuple[jax.Array, jax.Array]:
    """Track [N, 2] (x, y) points from prev to next frame.

    Returns (new_points [N, 2], valid [N] bool).  Coarse-to-fine like
    pyramidalLKCpu (pyramidalLK.cpp:314-370).
    """
    prev_pyr = build_pyramid(prev_gray.astype(jnp.float32), levels)
    next_pyr = build_pyramid(next_gray.astype(jnp.float32), levels)

    def track_one(pt):
        flow = jnp.zeros(2)
        ok = jnp.asarray(True)
        for lvl in range(levels - 1, -1, -1):
            scale = 1.0 / (1 << lvl)
            f, o = _lk_level(prev_pyr[lvl], next_pyr[lvl], pt * scale,
                             flow, patch, iterations)
            ok = ok & o
            if lvl == 0:
                ok = ok & _inside(pt, f, prev_pyr[0].shape, patch)
            flow = f * 2.0 if lvl > 0 else f
        return pt + flow, ok

    return jax.vmap(track_one)(points)
