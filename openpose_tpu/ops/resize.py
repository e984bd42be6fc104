"""Resize ops as dense interpolation-matrix contractions.

Interpolation is expressed as two small matmuls per image —
``out = W_h @ img @ W_w^T`` — instead of gather loops: the weights depend only
on the (static) sizes, so they are built once in numpy.  Three samplers are provided, matching the reference's three code paths:

* ``upsample_merge``: the heatmap upsample + multi-scale average.  Semantics
  follow the reference CUDA kernels (Catmull-Rom cubic, half-pixel centers,
  clamped taps): resize8TimesKernel / resizeAndAddAndAverageKernel in
  src/openpose/net/resizeAndMergeBase.cu:106-196 with tap layout
  cubicSequentialData in include/openpose_private/gpu/cuda.hu:92-121.
* ``resize_fixed_aspect``: input preprocessing.  The reference uses
  cv::warpAffine with a pure-scale matrix and black border
  (src/openpose/utilities/openCvPrivate.cpp:34-53): integer-grid mapping
  (src = dst/scale, no half-pixel shift), bilinear taps (warpAffine has no
  INTER_AREA path), zero outside the source.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _cubic_weights(d: np.ndarray, a: float) -> np.ndarray:
    """Weights of the 4 cubic taps at fractional offset d in [~0,1).

    a=-0.5 reproduces the reference cubicInterpolate (Catmull-Rom,
    include/openpose_private/gpu/cuda.hu:110-121); a=-0.75 is OpenCV's
    INTER_CUBIC table.  Shape: d (N,) -> (N, 4).
    """
    d = d.astype(np.float64)
    d2, d3 = d * d, d * d * d
    if a == -0.5:  # Catmull-Rom, matches the reference formula exactly
        w0 = -0.5 * d3 + d2 - 0.5 * d
        w1 = 1.5 * d3 - 2.5 * d2 + 1.0
        w2 = -1.5 * d3 + 2.0 * d2 + 0.5 * d
        w3 = 0.5 * d3 - 0.5 * d2
    else:
        # General Keys kernel evaluated at distances |d+1|, |d|, |1-d|, |2-d|
        def k(t):
            at = np.abs(t)
            return np.where(
                at <= 1, (a + 2) * at**3 - (a + 3) * at**2 + 1,
                np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0))
        w0, w1, w2, w3 = k(d + 1), k(d), k(1 - d), k(2 - d)
    return np.stack([w0, w1, w2, w3], axis=1)


@functools.lru_cache(maxsize=None)
def _cubic_matrix(out_size: int, in_size: int, scale: float, a: float = -0.5,
                  half_pixel: bool = True) -> np.ndarray:
    """(out_size, in_size) matrix for 1-D cubic resampling.

    Tap positions and dx follow cubicSequentialData (cuda.hu:92-107): t1 =
    clamp(floor(src), 0, in-1), t0 = max(0, t1-1), t2/t3 clamped increments,
    dx = src - t1 (using the *clamped* t1, reproducing the border behavior).
    """
    x = np.arange(out_size, dtype=np.float64)
    src = (x + 0.5) / scale - 0.5 if half_pixel else x / scale
    t1 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    t0 = np.maximum(0, t1 - 1)
    t2 = np.minimum(in_size - 1, t1 + 1)
    t3 = np.minimum(in_size - 1, t2 + 1)
    d = src - t1
    w = _cubic_weights(d, a)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i, taps in enumerate((t0, t1, t2, t3)):
        np.add.at(mat, (x.astype(np.int64), taps), w[:, i])
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(out_size: int, in_size: int, scale: float,
                     half_pixel: bool = False) -> np.ndarray:
    """(out_size, in_size) bilinear matrix; src coords outside [0, in) get
    zero weight (cv::warpAffine BORDER_CONSTANT black)."""
    x = np.arange(out_size, dtype=np.float64)
    src = (x + 0.5) / scale - 0.5 if half_pixel else x / scale
    lo = np.floor(src).astype(np.int64)
    d = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for taps, w in ((lo, 1.0 - d), (lo + 1, d)):
        valid = (taps >= 0) & (taps < in_size)
        np.add.at(mat, (x[valid].astype(np.int64), taps[valid]), w[valid])
    return mat.astype(np.float32)


def _apply_matrices(x: jax.Array, mh: np.ndarray, mw: np.ndarray,
                    precision=None) -> jax.Array:
    """NHWC tensor resample: out[b,y,x,c] = sum_ij mh[y,i] x[b,i,j,c] mw[x,j].

    precision: pass jax.lax.Precision.HIGHEST for heatmap-path resampling.
    Under DEFAULT precision f32 operands may be multiplied at reduced
    precision (TF32 on the GPU); on near-flat Gaussian tops the quantization
    makes adjacent
    upsampled pixels exactly equal, and the strict `>` 3x3 NMS rule then
    sees a plateau and drops the peak entirely (observed: missing parts and
    ~1 px peak shifts on device vs the f32 oracle).  Image preprocessing
    keeps DEFAULT (inputs are 8-bit; the CNN consumes bf16 anyway)."""
    wh = jnp.asarray(mh, x.dtype)
    ww = jnp.asarray(mw, x.dtype)
    out = jnp.einsum("yi,bijc->byjc", wh, x,
                     preferred_element_type=jnp.float32, precision=precision)
    out = jnp.einsum("xj,byjc->byxc", ww, out.astype(x.dtype),
                     preferred_element_type=jnp.float32, precision=precision)
    return out


def resize_bicubic(x: jax.Array, target_hw: Tuple[int, int]) -> jax.Array:
    """Catmull-Rom upsample of NHWC maps to target (H, W), half-pixel centers.

    Single-scale path of the reference resize (resizeAndMergeBase.cu:36-54
    resizeKernel / :106-163 resize8TimesKernel — both reduce to the same math).
    """
    th, tw = target_hw
    h, w = x.shape[1], x.shape[2]
    return _apply_matrices(
        x, _cubic_matrix(th, h, th / h), _cubic_matrix(tw, w, tw / w),
        precision=jax.lax.Precision.HIGHEST)


def upsample_merge(sources: Sequence[jax.Array],
                   scale_ratios: Sequence[float],
                   target_hw: Tuple[int, int]) -> jax.Array:
    """Multi-scale resize-and-average of heatmaps onto the main-scale grid.

    Mirrors resizeAndAddAndAverageKernel (resizeAndMergeBase.cu:165-196) with
    per-scale sampling scale ``(target/source0) / (s_i/s_0)`` from
    resizeAndMergeGpu (resizeAndMergeBase.cu:378-436).

    sources: list of NHWC heatmaps, one per scale (scale 0 = largest).
    scale_ratios: scaleInputToNetInput per scale.
    """
    th, tw = target_hw
    h0, w0 = sources[0].shape[1], sources[0].shape[2]
    acc = None
    for i, src in enumerate(sources):
        rel = scale_ratios[i] / scale_ratios[0]
        scale_h = (th / h0) / rel
        scale_w = (tw / w0) / rel
        out = _apply_matrices(
            src,
            _cubic_matrix(th, src.shape[1], scale_h),
            _cubic_matrix(tw, src.shape[2], scale_w),
            precision=jax.lax.Precision.HIGHEST)
        acc = out if acc is None else acc + out
    return acc / len(sources)


def resize_fixed_aspect(image: jax.Array, scale: float,
                        target_hw: Tuple[int, int]) -> jax.Array:
    """Scale NHWC image by `scale` into a (H, W) canvas, zero-padded
    bottom/right — the reference's resizeFixedAspectRatio
    (src/openpose/utilities/openCvPrivate.cpp:34-53).

    warpAffine semantics: integer-grid mapping src = dst/scale, bilinear taps,
    black border.  (The reference requests INTER_CUBIC for upscale, but uses
    bilinear for the typical downscale path; we use the cubic matrix when
    scale > 1 to match.)
    """
    th, tw = target_hw
    h, w = image.shape[1], image.shape[2]
    if scale > 1.0:
        mh = _cubic_matrix(th, h, scale, a=-0.75, half_pixel=False).copy()
        mw = _cubic_matrix(tw, w, scale, a=-0.75, half_pixel=False).copy()
        # zero out rows that map fully outside the source
        oy = np.arange(th) / scale
        ox = np.arange(tw) / scale
        mh[oy > h - 1 + 1e-9] = 0
        mw[ox > w - 1 + 1e-9] = 0
    else:
        mh = _bilinear_matrix(th, h, scale)
        mw = _bilinear_matrix(tw, w, scale)
    return _apply_matrices(image, mh, mw)


def normalize_vgg(image: jax.Array) -> jax.Array:
    """VGG input normalization x/256 - 0.5 (reference:
    src/openpose/utilities/openCv.cpp uCharCvMatToFloatPtr, normalize==1)."""
    return image * (1.0 / 256.0) - 0.5
