"""Batched affine crop: extract per-person square ROIs as net inputs.

Replaces the reference's per-person cv::warpAffine calls
(src/openpose/face/faceExtractorCaffe.cpp:231-244, hand cropFrame in
src/openpose/hand/handExtractorCaffe.cpp:44-74) with ONE batched gather:
all people of a frame are cropped in a single device op, so the downstream
face/hand CNN runs a single batched forward instead of a per-person loop
(the reference's known O(#people) weakness, SURVEY §7 "Hard parts").

Semantics per crop (WARP_INVERSE_MAP): dst(x, y) = src(a*x + tx, s*y + ty)
with a = -s, tx = rect.x + rect.w for mirrored (left-hand) crops;
bilinear taps, black constant border.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _bilinear_weights_dyn(scale: jax.Array, trans: jax.Array,
                          out_size: int, in_size: int) -> jax.Array:
    """[P] per-crop (scale, trans) -> [P, out_size, in_size] bilinear
    interpolation matrices built ON DEVICE (the transforms are runtime
    values).  Row p,o holds weight (1-d) at floor(src) and d at
    floor(src)+1 for src = scale*o + trans; out-of-range taps get zero
    weight (cv::warpAffine BORDER_CONSTANT black)."""
    o = jnp.arange(out_size, dtype=jnp.float32)
    src = scale[:, None] * o[None, :] + trans[:, None]       # [P, O]
    lo = jnp.floor(src)
    d = (src - lo)[..., None]                                # [P, O, 1]
    cols = jnp.arange(in_size, dtype=jnp.float32)[None, None, :]
    lo = lo[..., None]
    return (jnp.where(cols == lo, 1.0 - d, 0.0)
            + jnp.where(cols == lo + 1.0, d, 0.0))


@functools.partial(jax.jit, static_argnames=("out_size",))
def crop_affine_batch(image: jax.Array, transforms: jax.Array,
                      out_size=368) -> jax.Array:
    """image: [H, W, 3] float; transforms: [P, 4] rows (sx, sy, tx, ty)
    meaning src_x = sx*dst_x + tx, src_y = sy*dst_y + ty.
    out_size: int (square) or (out_h, out_w).
    Returns [P, out_h, out_w, 3]; out-of-image samples are 0.

    The transform family is axis-aligned (pure scale + translate — mirrors
    are a negative sx), so the warp is SEPARABLE: one [out_h, H] row matrix
    and one [out_w, W] column matrix per crop, as two batched matmuls,
    bit-equivalent to the 4-tap gather formulation (same taps, same zero
    border).
    """
    out_h, out_w = (out_size, out_size) if isinstance(out_size, int) \
        else out_size
    h, w = image.shape[0], image.shape[1]
    wy = _bilinear_weights_dyn(transforms[:, 1], transforms[:, 3],
                               out_h, h)                 # [P, out_h, H]
    wx = _bilinear_weights_dyn(transforms[:, 0], transforms[:, 2],
                               out_w, w)                 # [P, out_w, W]
    img = image.astype(jnp.float32)
    # rows then columns; HIGHEST keeps full f32 (8-bit image values would
    # survive bf16, but crops also feed parity tests against exact taps)
    tmp = jnp.einsum("pyh,hwc->pywc", wy, img,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("pxw,pywc->pyxc", wx, tmp,
                      precision=jax.lax.Precision.HIGHEST)


def rect_to_transform(rect_xywh, net_side: int, mirror: bool):
    """(x, y, w, h) square rect -> (sx, sy, tx, ty) row.

    Mirrored crops use sx = -scale, tx = x + w (cropFrame,
    handExtractorCaffe.cpp:51-62)."""
    x, y, rw, rh = rect_xywh
    scale = max(rw, rh) / float(net_side)
    if mirror:
        return (-scale, scale, x + rw, y)
    return (scale, scale, x, y)


def map_forward(keypoints_xy, transform):
    """Inverse of map_back: [.., 2] image-space keypoints -> crop space
    (dst = (src - t) / s per axis)."""
    sx, sy, tx, ty = transform
    import numpy as np
    out = np.asarray(keypoints_xy, dtype=np.float32).copy()
    out[..., 0] = (keypoints_xy[..., 0] - tx) / sx
    out[..., 1] = (keypoints_xy[..., 1] - ty) / sy
    return out


def map_back(keypoints_xy, transform):
    """Map [.., 2] crop-space keypoints back to image space via the same
    affine (connectKeypoints, handExtractorCaffe.cpp:76-95)."""
    sx, sy, tx, ty = transform
    import numpy as np
    out = np.asarray(keypoints_xy, dtype=np.float32).copy()
    out[..., 0] = sx * keypoints_xy[..., 0] + tx
    out[..., 1] = sy * keypoints_xy[..., 1] + ty
    return out
