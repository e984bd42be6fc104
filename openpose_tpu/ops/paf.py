"""PAF line-integral pair scoring on device.

Computes, for every limb pair (A-part, B-part) and every candidate peak
combination (i, j), the part-affinity support of the connection: sample the
PAF vector field along the A->B segment, count samples whose directional
projection exceeds `inter_threshold`, and average if enough of the line
agrees.  Mirrors the reference GPU kernel `pafScoreKernel` / `process`
(src/openpose/net/bodyPartConnectorBase.cu:12-146), which also reads the
materialized full-resolution merged map (resizeAndMerge of every channel):

* number of samples: max(5, min(25, round(sqrt(5 * linf_dist)))) — evaluated
  with a static 25-sample grid + mask (static shapes, bit-identical sums);
* sample location: round(start + t * step), clamped to the map;
* acceptance: count / n_samples > inter_min_above_threshold -> sum / count;
* close-keypoint fallback (bodyPartConnectorBase.cu:53-64): if the line fails
  but |AB| < sqrt(W*H)/150, emit default_nms_threshold + 1e-6;
* invalid combinations (peak index >= peak count) score -1.

Sampling is an element gather from the merged map, one per sample and PAF
component, for every slot of the static peak budget.  On the GPU this beat
evaluating the upsample analytically per sample as Catmull-Rom tap-matrix
products at every peak count measured (PERF.md).

Output: [N, P, max_peaks, max_peaks] float32.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_LINE_SAMPLES = 25


def _line_geometry(peaks: jax.Array, pairs: jax.Array, hw: Tuple[int, int]):
    """Shared geometry: sample pixel coords + masks for all (pair, i, j).

    Returns dict with mx, my [N,P,K,K,L] int32 sample pixels in the target
    grid, plus per-(i,j) quantities (ux, uy, n_samples, norm, validity).
    """
    h, w = hw
    counts = peaks[:, :, 0, 0]                       # [N, parts]
    coords = peaks[:, :, 1:, :]                      # [N, parts, K, 3]
    max_peaks = coords.shape[2]

    a_part = pairs[:, 0]
    b_part = pairs[:, 1]
    # NOTE: index then slice; a combined coords[:, a_part, :, 0] triggers
    # NumPy's advanced-indexing transpose (advanced axes move to the front).
    ca = coords[:, a_part]                           # [N, P, K, 3]
    cb = coords[:, b_part]
    ax, ay = ca[..., 0], ca[..., 1]
    bx, by = cb[..., 0], cb[..., 1]
    count_a = counts[:, a_part]                      # [N, P]
    count_b = counts[:, b_part]

    vx = bx[:, :, None, :] - ax[:, :, :, None]       # [N, P, K, K]
    vy = by[:, :, None, :] - ay[:, :, :, None]
    linf = jnp.maximum(jnp.abs(vx), jnp.abs(vy))
    n_samples = jnp.clip(jnp.floor(jnp.sqrt(5.0 * linf) + 0.5), 5, 25)
    norm = jnp.sqrt(vx * vx + vy * vy)
    safe_norm = jnp.where(norm > 1e-6, norm, 1.0)

    lm = jnp.arange(MAX_LINE_SAMPLES, dtype=jnp.float32)
    sx = ax[:, :, :, None, None] + lm * (vx / n_samples)[..., None]
    sy = ay[:, :, :, None, None] + lm * (vy / n_samples)[..., None]
    mx = jnp.clip(jnp.floor(sx + 0.5), 0, w - 1).astype(jnp.int32)
    my = jnp.clip(jnp.floor(sy + 0.5), 0, h - 1).astype(jnp.int32)

    ki = jnp.arange(max_peaks, dtype=jnp.float32)
    valid = (ki[None, None, :, None] < count_a[..., None, None]) & \
            (ki[None, None, None, :] < count_b[..., None, None])
    return dict(mx=mx, my=my, ux=vx / safe_norm, uy=vy / safe_norm,
                n_samples=n_samples, norm=norm, valid=valid)


def _finalize(proj_x, proj_y, geo, hw, inter_threshold,
              inter_min_above_threshold, default_nms_threshold):
    """From per-sample PAF components to final pair scores."""
    h, w = hw
    lm = jnp.arange(MAX_LINE_SAMPLES, dtype=jnp.float32)
    proj = geo["ux"][..., None] * proj_x + geo["uy"][..., None] * proj_y
    sample_valid = lm < geo["n_samples"][..., None]
    above = (proj > inter_threshold) & sample_valid
    cnt = above.sum(axis=-1).astype(jnp.float32)
    ssum = jnp.where(above, proj, 0.0).sum(axis=-1)

    accepted = cnt / geo["n_samples"] > inter_min_above_threshold
    score = jnp.where(accepted, ssum / jnp.maximum(cnt, 1.0), -1.0)
    close_thr = jnp.sqrt(jnp.float32(w * h)) / 150.0
    fallback = (~accepted) & (geo["norm"] < close_thr)
    score = jnp.where(fallback, default_nms_threshold + 1e-6, score)
    score = jnp.where(geo["norm"] > 1e-6, score, -1.0)
    return jnp.where(geo["valid"], score, -1.0)


@jax.jit
def paf_scores(heatmaps: jax.Array, peaks: jax.Array, pairs: jax.Array,
               map_idx: jax.Array, inter_threshold: jax.Array,
               inter_min_above_threshold: jax.Array,
               default_nms_threshold: jax.Array) -> jax.Array:
    """Pair scores by gathering from the merged [N, H, W, C] net output
    (resize.upsample_merge of every channel).

    map_idx: [P, 2] absolute PAF channel indices (offset by parts + bkg as in
    BodyPartConnectorCaffe, src/openpose/net/bodyPartConnectorBase.cpp:173).
    """
    heat = heatmaps.astype(jnp.float32)
    n, h, w, c = heat.shape
    geo = _line_geometry(peaks, pairs, (h, w))
    flat = geo["my"] * w + geo["mx"]                 # [N, P, K, K, L]

    heat_c = heat.transpose(0, 3, 1, 2).reshape(n, c, h * w)
    map_x = heat_c[:, map_idx[:, 0]]
    map_y = heat_c[:, map_idx[:, 1]]
    p = pairs.shape[0]
    flat2 = flat.reshape(n, p, -1)
    proj_x = jnp.take_along_axis(map_x, flat2, axis=-1).reshape(flat.shape)
    proj_y = jnp.take_along_axis(map_y, flat2, axis=-1).reshape(flat.shape)
    return _finalize(proj_x, proj_y, geo, (h, w), inter_threshold,
                     inter_min_above_threshold, default_nms_threshold)


def pair_tables(info) -> Tuple[np.ndarray, np.ndarray]:
    """Build (pairs [P,2], absolute map_idx [P,2]) int32 tables for a model.

    The +offset mirrors BodyPartConnectorCaffe which adds
    (numberBodyParts + bkg) to POSE_MAP_INDEX before the GPU kernel
    (reference: src/openpose/net/bodyPartConnectorBase.cpp:173-175)."""
    pairs = np.asarray(info.pairs, np.int32).reshape(-1, 2)
    midx = np.asarray(info.map_idx, np.int32).reshape(-1, 2) + info.paf_channel_offset
    return pairs, midx
