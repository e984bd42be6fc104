"""JAX executor for the OpenPose CNN graphs (VGG trunk + CPM/PAF stages).

The reference runs these nets through Caffe (reference:
src/openpose/net/netCaffe.cpp:213-262).  Here the whole graph is a pure JAX
function over an NHWC activation dict: traced once per input shape and
compiled by XLA (convolutions go to cuDNN on the GPU).  Layout notes:

* Activations are NHWC; Caffe is NCHW.  Channel *order* inside
  the C axis (BGR for the image, Caffe channel order for weights) is kept so
  converted caffemodel weights are drop-in.
* Conv weights are HWIO; `convert_caffe_blobs` transposes Caffe's OIHW.
* Compute dtype is configurable: bf16 (the inference default) runs on the
  tensor cores; f32 is used in parity tests.  Accumulation is always f32 via
  `preferred_element_type`.
* Caffe pooling uses ceil-mode output sizes; OpenPose inputs are multiples of
  16 so all three 2x2/s2 pools divide evenly, but the general case pads
  bottom/right with -inf like Caffe does implicitly.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openpose_tpu.models.caffe_proto import LayerSpec, NetSpec

Params = Dict[str, Dict[str, jax.Array]]

_SPEC_DIR = pathlib.Path(__file__).parent / "specs"


@functools.lru_cache(maxsize=None)
def load_spec(name: str) -> NetSpec:
    """Load a bundled topology spec (generated by tools/gen_specs.py)."""
    with open(_SPEC_DIR / f"{name}.json") as f:
        return NetSpec.from_json(json.load(f))


def init_params(spec: NetSpec, rng: jax.Array, dtype=jnp.float32) -> Params:
    """He-normal initialization for every learnable layer in the graph."""
    params: Params = {}
    channels: Dict[str, int] = {spec.input: spec.input_channels}
    for layer in spec.layers:
        if layer.type == "Convolution":
            c_in = channels[layer.bottoms[0]]
            rng, k = jax.random.split(rng)
            fan_in = layer.kernel * layer.kernel * c_in
            w = jax.random.normal(
                k, (layer.kernel, layer.kernel, c_in, layer.num_output), dtype
            ) * jnp.asarray(np.sqrt(2.0 / fan_in), dtype)
            params[layer.name] = {
                "w": w, "b": jnp.zeros((layer.num_output,), dtype)}
            for top in layer.tops:
                channels[top] = layer.num_output
        elif layer.type == "PReLU":
            c = channels[layer.bottoms[0]]
            params[layer.name] = {"slope": jnp.full((c,), 0.25, dtype)}
        elif layer.type == "Concat":
            c = sum(channels[b] for b in layer.bottoms)
            for top in layer.tops:
                channels[top] = c
        else:  # ReLU / Pooling keep channels
            for top in layer.tops:
                channels[top] = channels[layer.bottoms[0]]
    return params


def convert_caffe_blobs(
        spec: NetSpec, blobs: Dict[str, Any], dtype=jnp.float32) -> Params:
    """Convert parse_caffemodel() output into this executor's param pytree.

    Caffe conv blobs are OIHW -> HWIO; bias is 1-D; PReLU slope is per-channel.
    PReLU blobs in CMU caffemodels are stored under the PReLU layer name.
    """
    params: Params = {}
    for layer in spec.layers:
        if layer.type == "Convolution":
            lb = blobs[layer.name]
            w = np.asarray(lb[0], np.float32)
            if w.ndim != 4:
                w = w.reshape(layer.num_output, -1, layer.kernel, layer.kernel)
            params[layer.name] = {
                "w": jnp.asarray(w.transpose(2, 3, 1, 0), dtype),
                "b": jnp.asarray(
                    np.asarray(lb[1], np.float32).reshape(-1)
                    if len(lb) > 1 else np.zeros(layer.num_output), dtype),
            }
        elif layer.type == "PReLU":
            lb = blobs[layer.name]
            params[layer.name] = {
                "slope": jnp.asarray(np.asarray(lb[0], np.float32).reshape(-1), dtype)}
    return params


def _conv(x: jax.Array, layer: LayerSpec, p: Dict[str, jax.Array],
          compute_dtype) -> jax.Array:
    # The input layer (cin=3) is a direct conv; im2col and space-to-depth
    # rewrites are candidates not measured on the GPU (ROADMAP S8, PERF.md).
    w = p["w"].astype(compute_dtype)
    out = jax.lax.conv_general_dilated(
        x.astype(compute_dtype), w,
        window_strides=(layer.stride, layer.stride),
        padding=[(layer.pad, layer.pad), (layer.pad, layer.pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return (out + p["b"].astype(jnp.float32)).astype(compute_dtype)


def _max_pool(x: jax.Array, layer: LayerSpec) -> jax.Array:
    k, s = layer.kernel, layer.stride
    h, w = x.shape[1], x.shape[2]
    # Caffe ceil-mode output: ceil((dim + 2p - k)/s) + 1
    out_h = -(-(h + 2 * layer.pad - k) // s) + 1
    out_w = -(-(w + 2 * layer.pad - k) // s) + 1
    pad_h = (s * (out_h - 1) + k) - h
    pad_w = (s * (out_w - 1) + k) - w
    return jax.lax.reduce_window(
        x, -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else x.dtype.type(0),
        jax.lax.max, (1, k, k, 1), (1, s, s, 1),
        [(0, 0), (layer.pad, pad_h - layer.pad), (layer.pad, pad_w - layer.pad),
         (0, 0)])


def forward(params: Params, spec: NetSpec, image: jax.Array,
            compute_dtype=jnp.bfloat16) -> jax.Array:
    """Run the net: image [N,H,W,3] (BGR, normalized) -> [N,H/8,W/8,C] f32.

    The per-layer chain mirrors the Caffe graph execution
    (reference: src/openpose/net/netCaffe.cpp:213-262 forwardPass).
    """
    acts: Dict[str, jax.Array] = {spec.input: image.astype(compute_dtype)}
    for layer in spec.layers:
        if layer.type == "Convolution":
            out = _conv(acts[layer.bottoms[0]], layer, params[layer.name],
                        compute_dtype)
        elif layer.type == "ReLU":
            out = jnp.maximum(acts[layer.bottoms[0]], 0)
        elif layer.type == "PReLU":
            x = acts[layer.bottoms[0]]
            slope = params[layer.name]["slope"].astype(x.dtype)
            out = jnp.where(x >= 0, x, x * slope)
        elif layer.type == "Pooling":
            out = _max_pool(acts[layer.bottoms[0]], layer)
        elif layer.type == "Concat":
            out = jnp.concatenate([acts[b] for b in layer.bottoms], axis=-1)
        else:
            raise ValueError(f"unsupported layer type: {layer.type}")
        for top in layer.tops:
            acts[top] = out
    return acts[spec.output].astype(jnp.float32)


def count_flops(spec: NetSpec, hw: Tuple[int, int], in_channels: int = 3
                ) -> Dict[str, int]:
    """Per-layer MAC-based FLOPs (2*MACs) for one image at input (H, W).

    Shape propagation mirrors forward()/_max_pool (Caffe ceil-mode pooling).
    Returns {layer_name: flops}; sum the values for the per-image total.
    Used by bench.py's MFU accounting (north star: CNN at speed-of-light)."""
    shapes: Dict[str, Tuple[int, int, int]] = {
        spec.input: (hw[0], hw[1], in_channels)}
    flops: Dict[str, int] = {}
    for layer in spec.layers:
        h, w, c = shapes[layer.bottoms[0]]
        if layer.type == "Convolution":
            k, s, p = layer.kernel, layer.stride, layer.pad
            oh = (h + 2 * p - k) // s + 1
            ow = (w + 2 * p - k) // s + 1
            out = (oh, ow, layer.num_output)
            flops[layer.name] = 2 * k * k * c * layer.num_output * oh * ow
        elif layer.type == "Pooling":
            k, s, p = layer.kernel, layer.stride, layer.pad
            oh = -(-(h + 2 * p - k) // s) + 1
            ow = -(-(w + 2 * p - k) // s) + 1
            out = (oh, ow, c)
            flops[layer.name] = k * k * c * oh * ow
        elif layer.type in ("ReLU", "PReLU"):
            out = (h, w, c)
            flops[layer.name] = h * w * c
        elif layer.type == "Concat":
            out = (h, w, sum(shapes[b][2] for b in layer.bottoms))
            flops[layer.name] = 0
        else:
            raise ValueError(f"unsupported layer type: {layer.type}")
        for top in layer.tops:
            shapes[top] = out
    return flops
