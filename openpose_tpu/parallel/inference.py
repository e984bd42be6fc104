"""Sharded batch inference: data-parallel frame batches over the mesh.

The reference scales inference with one net replica per GPU fed round-robin
(SURVEY §2.2 strategy 2).  The JAX equivalent: ONE jitted program over
a (data, model) mesh — frames shard over `data`, weights optionally shard
over `model` — and XLA GSPMD handles placement and collectives.  Multi-host:
the same program runs under jax.distributed with per-host data feeding
(each host supplies its local shard of the global batch).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openpose_tpu.models.zoo import Model
from openpose_tpu.ops import nms, paf, resize
from openpose_tpu.parallel import mesh as mesh_lib


class ShardedPoseInference:
    """Batched BODY-model inference sharded over a device mesh."""

    def __init__(self, model: Model, mesh: Optional[Mesh] = None,
                 net_hw: Tuple[int, int] = (368, 656),
                 max_peaks: int = 127, nms_threshold: float = 0.05,
                 inter_threshold: float = 0.05,
                 inter_min_above_threshold: float = 0.95,
                 compute_dtype=jnp.bfloat16,
                 scale_number: int = 1, scale_gap: float = 0.25,
                 frame_hw: Optional[Tuple[int, int]] = None,
                 net_bypass: bool = False):
        """frame_hw: if given, __call__ takes RAW frames [B, fh, fw, 3] and
        the device program does the aspect-preserving resize to every scale
        itself (exact multi-scale reference semantics: each scale resamples
        the original frame, scaleAndSizeExtractor.cpp:37-112).  If None,
        inputs are pre-resized scale-0 net inputs (upload-minimal path) and
        smaller scales are derived on-device from the scale-0 canvas.

        net_bypass: __call__ takes net-output tensors
        [B, net_h/8, net_w/8, C] instead of images and the sharded program
        skips the CNN, running only resize-merge -> NMS -> PAF scoring —
        the reference's Datum::poseNetOutput injection hook
        (include/openpose/core/datum.hpp:212-217,
        poseExtractorCaffe.cpp:249-262) inside the same data-parallel
        program.  Single-scale only, like the reference hook."""
        self.model = model
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.net_hw = net_hw
        self.max_peaks = max_peaks
        self.thresholds = (nms_threshold, inter_threshold,
                           inter_min_above_threshold)
        self.compute_dtype = compute_dtype
        self.frame_hw = frame_hw
        self.net_bypass = net_bypass
        if net_bypass and (scale_number != 1 or frame_hw is not None):
            raise ValueError("net_bypass supports only single-scale, "
                             "pre-sized inputs (like the reference hook)")
        info = model.info
        self._pairs = jnp.asarray(paf.pair_tables(info)[0])
        self._map_idx = jnp.asarray(paf.pair_tables(info)[1])
        self._num_parts = info.num_parts

        from openpose_tpu.pose import scaler
        net_h, net_w = net_hw
        in_wh = ((net_w, net_h) if frame_hw is None
                 else (frame_hw[1], frame_hw[0]))
        self.plan = scaler.extract_scales(
            in_wh, (net_w, net_h), scale_number, scale_gap)
        # net-output px -> input px (poseExtractorCaffe.cpp:306-311);
        # identity when inputs are already net-sized
        net_size = (int(self.plan.scale_input_to_net[0] * in_wh[0] + 0.5),
                    int(self.plan.scale_input_to_net[0] * in_wh[1] + 0.5))
        self.scale_net_to_output = scaler.resize_get_scale_factor(
            net_size, in_wh)

        self.params = jax.device_put(
            model.params, mesh_lib.param_sharding(self.mesh, model.params))
        self._fn = self._build()
        self._slicers = {}

    def _build(self):
        net_h, net_w = self.net_hw
        nms_thr, inter_thr, inter_min = self.thresholds
        num_parts = self._num_parts
        pairs, map_idx = self._pairs, self._map_idx
        spec = self.model.spec
        dtype = self.compute_dtype
        max_peaks = self.max_peaks

        plan = self.plan
        raw_frames = self.frame_hw is not None
        sizes = plan.net_input_sizes
        scales = plan.scale_input_to_net

        bypass = self.net_bypass

        def run(params, images):
            from openpose_tpu.models import graph as _graph
            # uint8 frames normalize on-device (XLA fuses the scale/shift
            # into the first conv); shipping uint8 instead of float32
            # quarters host->device transfer volume.
            x = images.astype(jnp.float32)
            if bypass:
                # x IS the net output (poseNetOutput injection)
                sources = [x]
            else:
                sources = []
                for (w_i, h_i), s_i in zip(sizes, scales):
                    if raw_frames:
                        # exact reference path: each scale resamples the frame
                        net_in = resize.resize_fixed_aspect(x, s_i, (h_i, w_i))
                    elif (w_i, h_i) == (net_w, net_h):
                        net_in = x
                    else:
                        # derive from the scale-0 canvas (s_0 == 1 here)
                        net_in = resize.resize_fixed_aspect(
                            x, s_i / scales[0], (h_i, w_i))
                    sources.append(_graph.forward(
                        params, spec, resize.normalize_vgg(net_in), dtype))
            # every channel to net resolution (the reference's
            # resizeAndMerge): NMS reads the parts, PAF scoring the PAFs
            merged = resize.upsample_merge(sources, list(scales),
                                           (net_h, net_w))
            # +0.5 refinement offset in INPUT pixels after host rescale
            # (poseExtractorCaffe.cpp:317-318)
            off = float(0.5 / self.scale_net_to_output)
            peaks = nms.nms(merged[..., :num_parts], nms_thr, max_peaks,
                            offset=(off, off))
            scores = paf.paf_scores(merged, peaks, pairs, map_idx,
                                    inter_thr, inter_min, nms_thr)
            return peaks, scores

        batch_sh = mesh_lib.batch_sharding(self.mesh)
        if self.mesh.shape.get("model", 1) == 1:
            # Pure data parallelism: shard_map makes every op shard-local by
            # construction, so the compiled program is provably
            # collective-free (GSPMD's conservative gather/top_k partitioning
            # otherwise inserts all-gathers around the NMS compaction).
            # scripts/analyze_scaling.py verifies this from the HLO.
            run = jax.shard_map(
                run, mesh=self.mesh,
                in_specs=(P(), P("data")),
                out_specs=(P("data"), P("data")),
                check_vma=False)
        return jax.jit(run, in_shardings=(None, batch_sh),
                       out_shardings=(batch_sh, batch_sh))

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape["data"]

    def __call__(self, images: jax.Array):
        """images [B, net_h, net_w, 3] BGR, uint8 or float 0..255 (B
        divisible by the data axis); raw [B, fh, fw, 3] frames when
        constructed with frame_hw.

        Returns (peaks [B, parts, K+1, 3], pair_scores [B, P, K, K]).

        Multi-host: each process passes its PER-HOST shard of the global
        batch (jax.make_array_from_process_local_data assembles the global
        array; the reference's analogue is one frame queue per GPU thread,
        wrapperAuxiliary.hpp:1048-1067 — here each host feeds only the
        frames its local devices will process, so frame pixels never cross
        hosts).
        """
        batch_sh = mesh_lib.batch_sharding(self.mesh)
        if isinstance(images, jax.Array) and images.sharding == batch_sh:
            pass
        elif jax.process_count() > 1:
            images = jax.make_array_from_process_local_data(
                batch_sh, np.asarray(images))
        else:
            images = jax.device_put(images, batch_sh)
        return self._fn(self.params, images)

    # fetch-size ladder: the [B, P, K, K] pair-score tensor dominates
    # device->host volume (1.7 MB/frame at K=127) but frames rarely have
    # more than a handful of peaks per part, and assembly only reads the
    # [:count_a, :count_b] corner.  Slicing on-device before the fetch cuts
    # the transfer ~60x in the typical case (the device-side analogue of the
    # reference streaming only used candidates, bodyPartConnectorBase.cpp).
    SCORE_BUCKETS = (8, 16, 32, 64)

    def _slicer(self, k: int):
        if k not in self._slicers:
            self._slicers[k] = jax.jit(lambda s: s[:, :, :k, :k])
        return self._slicers[k]

    def fetch(self, peaks_dev: jax.Array, scores_dev: jax.Array
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Device outputs -> host arrays, score matrix truncated to the
        smallest bucket covering this batch's max per-part peak count."""
        return self.fetch_end(self.fetch_begin(peaks_dev, scores_dev))

    def fetch_begin(self, peaks_dev: jax.Array, scores_dev: jax.Array):
        """Start the device->host copies without blocking.

        Speculatively slices the pair-score matrix to the smallest bucket
        and starts both host copies; when the batch's true max peak count
        fits the bucket (the common case with trained weights),
        `fetch_end` completes without a second device dispatch and wait."""
        k0 = self.SCORE_BUCKETS[0]
        spec_dev = self._slicer(k0)(scores_dev)
        peaks_dev.copy_to_host_async()
        spec_dev.copy_to_host_async()
        return peaks_dev, scores_dev, spec_dev, k0

    def fetch_end(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        peaks_dev, scores_dev, spec_dev, k0 = handle
        peaks = np.asarray(peaks_dev)
        max_count = int(peaks[:, :, 0, 0].max()) if peaks.size else 0
        if max_count <= k0:
            return peaks, np.asarray(spec_dev)
        for k in self.SCORE_BUCKETS:
            if max_count <= k < self.max_peaks:
                return peaks, np.asarray(self._slicer(k)(scores_dev))
        return peaks, np.asarray(scores_dev)


class ShardedTopDown:
    """Batched per-person crop extraction for a whole frame-batch.

    The reference replicates the face/hand cascade per GPU and loops people
    within a frame (wrapperAuxiliary.hpp:324-337, faceExtractorCaffe.cpp:
    205-310); here every frame of the global batch crops up to `people_cap`
    ROIs from ITS OWN shard (a vmapped gather — no cross-shard indexing, so
    pure data parallelism stays collective-free) and one net forward covers
    all batch*people_cap crops.  The memory-heavy 8x upsample + argmax
    decode is lax.map-chunked over the people dimension.
    """

    def __init__(self, model: Model, mesh: Optional[Mesh] = None,
                 net_size: int = 368, people_cap: int = 8,
                 compute_dtype=jnp.bfloat16,
                 crop_tiers: Tuple[int, ...] = (2, 4)):
        """crop_tiers: ladder of smaller crop-count programs compiled
        alongside the full people_cap one.  A frame-batch whose highest
        ACTIVE slot fits a tier runs that tier's program and pays only
        tier * CNN-forward instead of people_cap * — the top-down analogue
        of the NMS fast_peaks ladder (ops/nms.py).  The reference pays
        O(#people) per frame (faceExtractorCaffe.cpp:230-310 loops people);
        the untier-ed batched program paid O(cap) even for 1 person."""
        self.model = model
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.net_size = net_size
        self.people_cap = people_cap
        self.compute_dtype = compute_dtype
        self.crop_tiers = tuple(
            t for t in sorted(crop_tiers) if 0 < t < people_cap)
        self.params = jax.device_put(
            model.params, mesh_lib.param_sharding(self.mesh, model.params))
        self._fns = {}
        self._bypass_fns = {}

    # transform row for an inactive slot: samples far outside -> all zeros
    INACTIVE = (1.0, 1.0, -1e6, -1e6)

    @staticmethod
    def _decode_chunked(out5d):
        """[B, P, s8, s8, C] net outputs -> [B, P, C, 3] crop-space peaks.

        The reference's decode semantics — 8x bicubic upsample then
        per-channel argmax (faceExtractorCaffe.cpp:230-310 /
        maximumBase.cpp:7-55) — computed by the windowed-refinement
        equivalent (ops/maximum.channel_argmax_refined): the full upsample
        materializes ~38 MB/crop of HBM traffic of which only the +-2 map
        px around each coarse peak can contain the argmax."""
        from openpose_tpu.ops import maximum
        b, p = out5d.shape[0], out5d.shape[1]
        maps = out5d.reshape((b * p,) + out5d.shape[2:])
        peaks = maximum.channel_argmax_refined(maps)   # [b*p, C, 3]
        return peaks.reshape((b, p) + peaks.shape[1:])

    def _fn(self, frame_hw: Tuple[int, int]):
        """The full-people_cap program (crop count = transforms.shape[1] at
        trace time; tier programs reuse the same builder via _tier_fn)."""
        return self._tier_fn(frame_hw, self.people_cap)

    def _tier_fn(self, frame_hw: Tuple[int, int], cap: int):
        if (frame_hw, cap) in self._fns:
            return self._fns[(frame_hw, cap)]
        from openpose_tpu.models import graph as _graph
        from openpose_tpu.ops import maximum, warp
        net_size = self.net_size
        spec = self.model.spec
        dtype = self.compute_dtype

        def run(params, frames, transforms):
            # frames [B, H, W, 3] uint8/f32; transforms [B, P, 4]
            f32 = frames.astype(jnp.float32)
            crops = jax.vmap(
                lambda im, tr: warp.crop_affine_batch(im, tr, net_size)
            )(f32, transforms)                      # [B, P, S, S, 3]
            b, p = crops.shape[0], crops.shape[1]
            x = resize.normalize_vgg(
                crops.reshape(b * p, net_size, net_size, 3))
            out = _graph.forward(params, spec, x, dtype)   # [b*p, s, s, C]
            return ShardedTopDown._decode_chunked(
                out.reshape((b, p) + out.shape[1:]))

        if self.mesh.shape.get("model", 1) == 1:
            run = jax.shard_map(
                run, mesh=self.mesh,
                in_specs=(P(), P("data"), P("data")),
                out_specs=P("data"), check_vma=False)
        batch_sh = mesh_lib.batch_sharding(self.mesh)
        fn = jax.jit(run, in_shardings=(None, batch_sh, batch_sh),
                     out_shardings=batch_sh)
        self._fns[(frame_hw, cap)] = fn
        return fn

    def _bypass_fn(self, map_hw: Tuple[int, int]):
        """Decode-only program: injected net outputs -> peaks (the
        poseNetOutput-style hook for the top-down stage, datum.hpp:212-217;
        used by the closed-loop face/hand accuracy harness)."""
        if map_hw in self._bypass_fns:
            return self._bypass_fns[map_hw]

        def run(maps):
            return ShardedTopDown._decode_chunked(maps.astype(jnp.float32))

        if self.mesh.shape.get("model", 1) == 1:
            run = jax.shard_map(run, mesh=self.mesh, in_specs=P("data"),
                                out_specs=P("data"), check_vma=False)
        batch_sh = mesh_lib.batch_sharding(self.mesh)
        fn = jax.jit(run, in_shardings=(batch_sh,), out_shardings=batch_sh)
        self._bypass_fns[map_hw] = fn
        return fn

    def tier_for(self, transforms: np.ndarray) -> int:
        """Smallest crop-tier covering every ACTIVE slot of this batch.

        Active slots are filled leading-first by the runtime
        (runtime/whole_body._run_topdown), so the highest active slot
        index bounds the crops that matter; trailing INACTIVE slots are
        exact zeros either way and can be dropped before the CNN."""
        active = transforms[..., 2] > -1e5            # INACTIVE tx = -1e6
        if not active.any():
            return self.crop_tiers[0] if self.crop_tiers else self.people_cap
        k_needed = int(np.max(np.where(active)[-1])) + 1
        for t in self.crop_tiers:
            if k_needed <= t:
                return t
        return self.people_cap

    def __call__(self, frames, transforms,
                 net_output=None) -> jax.Array:
        """frames [B, H, W, 3]; transforms [B, people_cap, 4] affine rows
        (warp.rect_to_transform).  Returns [B, people_cap, C, 3] peaks in
        CROP coordinates (map back with warp.map_back); slots beyond the
        selected crop tier are zero (they were INACTIVE by construction).

        net_output: optional [B, people_cap, s/8, s/8, C] tensor replacing
        the crop+CNN stages (decode-only injection)."""
        batch_sh = mesh_lib.batch_sharding(self.mesh)
        if net_output is not None:
            net_output = np.asarray(net_output, np.float32)
            fn = self._bypass_fn(tuple(net_output.shape[2:4]))
            return fn(jax.device_put(net_output, batch_sh))
        frames = np.asarray(frames)
        transforms = np.asarray(transforms, np.float32)
        tier = self.tier_for(transforms)
        fn = self._tier_fn(tuple(frames.shape[1:3]), tier)
        peaks = fn(self.params,
                   jax.device_put(frames, batch_sh),
                   jax.device_put(
                       np.ascontiguousarray(transforms[:, :tier]), batch_sh))
        if tier == self.people_cap:
            return peaks
        out = np.asarray(peaks)
        pad = np.zeros(
            (out.shape[0], self.people_cap - tier) + out.shape[2:],
            out.dtype)
        return np.concatenate([out, pad], axis=1)
