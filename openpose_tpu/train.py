"""Training step for the pose CNNs (heatmap + PAF regression).

The reference is inference-only (training lives in CMU's separate
openpose_train repo), but a complete framework must train: this module
implements the CPM/PAF training objective — L2 regression of predicted
part-confidence maps and part-affinity fields against rendered targets
(arXiv:1812.08008 §2) — as a jittable, shardable step.

Targets are built on device from keypoint annotations: Gaussian part maps and
line-segment PAFs at stride-8 resolution.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from openpose_tpu.models import graph
from openpose_tpu.models.caffe_proto import NetSpec


class TrainState(NamedTuple):
    params: Dict
    opt_state: optax.OptState
    step: jax.Array


def make_targets(keypoints: jax.Array, pairs: jax.Array, map_idx: jax.Array,
                 hw: Tuple[int, int], num_parts: int, num_channels: int,
                 stride: int = 8, sigma: float = 7.0,
                 paf_width: float = 1.0) -> jax.Array:
    """Render [B, H/stride, W/stride, C] training targets from keypoints.

    keypoints: [B, people, parts, 3] in input-pixel coords (score>0 = valid).
    Returns the same channel layout as net_output: parts, background, PAFs.
    """
    h, w = hw[0] // stride, hw[1] // stride
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * stride - 0.5
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * stride - 0.5
    grid_y = ys[:, None]
    grid_x = xs[None, :]

    kx = keypoints[..., 0]          # [B, P, parts]
    ky = keypoints[..., 1]
    kv = keypoints[..., 2] > 0

    # Part confidence maps: max over people of Gaussian(d2 / 2 sigma^2)
    d2 = ((grid_x[None, None, None] - kx[..., None, None]) ** 2
          + (grid_y[None, None, None] - ky[..., None, None]) ** 2)
    g = jnp.exp(-d2 / (2.0 * sigma * sigma))
    g = jnp.where(kv[..., None, None], g, 0.0)
    conf = g.max(axis=1)            # [B, parts, h, w]
    conf = conf.transpose(0, 2, 3, 1)
    bkg = jnp.clip(1.0 - conf.max(axis=-1, keepdims=True), 0.0, 1.0)

    # PAFs: unit vector along each limb within paf_width*stride of the segment
    pa = pairs[:, 0]
    pb = pairs[:, 1]
    ax_, ay_ = kx[:, :, pa], ky[:, :, pa]      # [B, P, pairs]
    bx_, by_ = kx[:, :, pb], ky[:, :, pb]
    pv = kv[:, :, pa] & kv[:, :, pb]
    vx = bx_ - ax_
    vy = by_ - ay_
    norm = jnp.sqrt(vx * vx + vy * vy)
    nz = norm > 1e-3
    ux = jnp.where(nz, vx / jnp.maximum(norm, 1e-3), 0.0)
    uy = jnp.where(nz, vy / jnp.maximum(norm, 1e-3), 0.0)
    # signed distances of each grid point
    px = grid_x[None, None, None] - ax_[..., None, None]
    py = grid_y[None, None, None] - ay_[..., None, None]
    along = px * ux[..., None, None] + py * uy[..., None, None]
    perp = jnp.abs(px * uy[..., None, None] - py * ux[..., None, None])
    # The stripe extends one grid cell beyond both endpoints, as in CMU's
    # openpose_train target renderer (putVecMaps expands the sampled x/y
    # range by `thre` = 1 cell); without the margin the stride-8 stripe can
    # end a full cell short of the joint and line-integral samples AT the
    # peak read near-zero — which fails the 95%-of-samples criterion and
    # disconnects short limbs (e.g. MidHip->RHip).
    margin = paf_width * stride
    on_limb = ((along >= -margin) & (along <= norm[..., None, None] + margin)
               & (perp <= paf_width * stride)
               & pv[..., None, None] & nz[..., None, None])
    # average over people that cover the pixel (reference training averages)
    cover = on_limb.sum(axis=1).astype(jnp.float32)
    denom = jnp.maximum(cover, 1.0)
    paf_x = jnp.where(on_limb, ux[..., None, None], 0.0).sum(axis=1) / denom
    paf_y = jnp.where(on_limb, uy[..., None, None], 0.0).sum(axis=1) / denom

    # Scatter PAF channels into their map_idx slots
    num_paf = num_channels - num_parts - 1
    paf = jnp.zeros((keypoints.shape[0], num_paf, h, w), jnp.float32)
    off = num_parts + 1
    paf = paf.at[:, map_idx[:, 0] - off].set(paf_x)
    paf = paf.at[:, map_idx[:, 1] - off].set(paf_y)
    paf = paf.transpose(0, 2, 3, 1)
    return jnp.concatenate([conf, bkg, paf], axis=-1)


def loss_fn(params, spec: NetSpec, images: jax.Array, targets: jax.Array,
            compute_dtype=jnp.float32) -> jax.Array:
    """Mean squared error between net output and rendered targets."""
    pred = graph.forward(params, spec, images, compute_dtype)
    return jnp.mean((pred - targets) ** 2)


def make_train_step(spec: NetSpec, optimizer: optax.GradientTransformation,
                    compute_dtype=jnp.float32):
    """Build a jittable (state, images, targets) -> (state, loss) step.

    compute_dtype defaults to f32 for TRAINING, which keeps the autodiff
    graph dtype-consistent (conv_general_dilated's transpose rejects a bf16
    operand against the f32 cotangent produced by
    preferred_element_type=f32).  Under DEFAULT precision the GPU runs f32
    convolutions in TF32, at half the bf16 tensor-core rate; a bf16
    training step is not measured yet (ROADMAP S9).  Inference keeps bf16
    activations."""

    def step(state: TrainState, images, targets):
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, spec, images, targets, compute_dtype)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def init_train_state(spec: NetSpec, optimizer: optax.GradientTransformation,
                     rng: jax.Array) -> TrainState:
    params = graph.init_params(spec, rng)
    return TrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
