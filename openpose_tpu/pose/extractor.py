"""Whole-body pose extraction pipeline: image -> people keypoints.

Device side (one fused jit program per input geometry): per-scale
resize+normalize -> CNN forward -> multi-scale resize-and-merge -> NMS ->
PAF pair scoring.  Host side: greedy people assembly.

Mirrors PoseExtractorCaffe::forwardPass
(src/openpose/pose/poseExtractorCaffe.cpp:200-340):

* resize-and-merge target = scale-0 net input size (upsamplingRatio<=0 path,
  poseExtractorCaffe.cpp:283-289);
* scale_net_to_output maps net-output pixels back to input pixels via the
  double resizeGetScaleFactor dance (poseExtractorCaffe.cpp:306-311);
* NMS offset = 0.5 / scale_net_to_output so refined peaks land on +0.5 input
  pixel centers after scaling (poseExtractorCaffe.cpp:317-318);
* NMS runs on the first num_parts channels only
  (poseExtractorCaffe.cpp:55-57 NmsCaffe::Reshape outputChannels).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openpose_tpu.models.zoo import Model
from openpose_tpu.ops import assembly, nms, paf, resize
from openpose_tpu.params import (
    POSE_MAX_PEOPLE, ConnectParams, PoseModel, default_connect_params)
from openpose_tpu.pose import scaler


@dataclasses.dataclass
class PosePrediction:
    """Keypoints in input-image pixel coordinates."""

    keypoints: np.ndarray          # [people, parts, 3] (x, y, score)
    scores: np.ndarray             # [people]
    heatmaps: Optional[np.ndarray] = None   # [h, w, C] merged low-res, all
    #                                         channels (parts + bkg + PAFs)
    peaks: Optional[np.ndarray] = None      # [parts, K+1, 3] net-output px
    scale_net_to_output: float = 1.0
    net_output_size: Tuple[int, int] = (0, 0)   # (w, h)
    # Per-scale geometry (Datum::scaleInputToNetInputs / netInputSizes,
    # include/openpose/core/datum.hpp:223-238)
    scale_input_to_net: Tuple[float, ...] = ()
    net_input_sizes: Tuple[Tuple[int, int], ...] = ()   # [(w, h), ...]


class PoseExtractor:
    """Multi-person 2D pose extractor for one pose model."""

    def __init__(self, model: Model, max_peaks: int = POSE_MAX_PEOPLE,
                 maximize_positives: bool = False,
                 compute_dtype=jnp.bfloat16,
                 connect_params: Optional[ConnectParams] = None):
        self.model = model
        self.info = model.info
        self.max_peaks = max_peaks
        self.maximize_positives = maximize_positives
        self.compute_dtype = compute_dtype
        self.connect = connect_params or default_connect_params(
            PoseModel(self.info.name), maximize_positives)
        self.pairs, self.map_idx = paf.pair_tables(self.info)
        self._device_fn_cache: Dict = {}

    # ------------------------------------------------------------------ #
    def _device_fn(self, in_hw: Tuple[int, int],
                   plan: scaler.ScalePlan, nms_offset: float):
        """Build/cache the jitted device program for one geometry."""
        key = (in_hw, plan.net_input_sizes, plan.scale_input_to_net, nms_offset)
        if key in self._device_fn_cache:
            return self._device_fn_cache[key]

        info = self.info
        num_parts = info.num_parts
        pairs = jnp.asarray(self.pairs)
        map_idx = jnp.asarray(self.map_idx)
        cp = self.connect
        max_peaks = self.max_peaks
        target_w, target_h = plan.net_input_sizes[0]
        compute_dtype = self.compute_dtype
        model = self.model

        def run(params, image_f32, injected=None):
            # image [1, H, W, 3] BGR float (0..255); injected: optional
            # [1, h/8, w/8, C] net output replacing the CNN (the reference's
            # Datum::poseNetOutput bypass, include/openpose/core/datum.hpp:
            # 212-217, poseExtractorCaffe.cpp:249-262).
            if injected is not None:
                sources = [injected.astype(jnp.float32)]
            else:
                sources = []
                for (w, h), s in zip(plan.net_input_sizes,
                                     plan.scale_input_to_net):
                    net_in = resize.resize_fixed_aspect(image_f32, s, (h, w))
                    net_in = resize.normalize_vgg(net_in)
                    from openpose_tpu.models import graph as _graph
                    sources.append(_graph.forward(params, model.spec, net_in,
                                                  compute_dtype))
            # Every channel to net resolution (the reference's
            # resizeAndMerge): NMS reads the parts, PAF scoring the PAFs.
            merged = resize.upsample_merge(
                sources, list(plan.scale_input_to_net), (target_h, target_w))
            merged_parts = merged[..., :num_parts]
            peaks = nms.nms(merged_parts, cp.nms_threshold,
                            max_peaks, offset=(nms_offset, nms_offset))
            scores = paf.paf_scores(
                merged, peaks, pairs, map_idx, cp.inter_threshold,
                cp.inter_min_above_threshold, cp.nms_threshold)
            # Low-res merged full tensor (parts+bkg+PAFs) for heatmap export:
            # average the low-res sources on the scale-0 grid (cheap).
            full_low = resize.upsample_merge(
                sources, list(plan.scale_input_to_net),
                (sources[0].shape[1], sources[0].shape[2]))
            return merged_parts, peaks, scores, full_low

        fn = jax.jit(run)
        self._device_fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------ #
    def assemble(self, peaks_np: np.ndarray, scores_np: np.ndarray,
                 scale_net_to_output: float):
        """Host tail for one frame (device outputs -> people)."""
        return assembly.connect_body_parts(
            scores_np, peaks_np, self.pairs, self.info.num_parts,
            self.connect.min_subset_cnt, self.connect.min_subset_score,
            scale_net_to_output, self.maximize_positives)

    # ------------------------------------------------------------------ #
    def forward(self, image: np.ndarray,
                net_resolution: Tuple[int, int] = (-1, 368),
                scale_number: int = 1, scale_gap: float = 0.25,
                keep_heatmaps: bool = False,
                net_output: Optional[np.ndarray] = None,
                net_resolution_dynamic: float = -1.0) -> PosePrediction:
        """image: [H, W, 3] uint8/float BGR.

        net_output: optional [h/8, w/8, C] heatmap tensor that bypasses the
        CNN (the reference's Datum::poseNetOutput hook, datum.hpp:212-217;
        tutorial 09_keypoints_from_heatmaps) — post-processing only.
        """
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(
                f"input image must be [H, W, 3] BGR, got shape {image.shape}")
        in_h, in_w = image.shape[:2]
        plan = scaler.extract_scales(
            (in_w, in_h), net_resolution, scale_number, scale_gap,
            net_resolution_dynamic=net_resolution_dynamic)

        # scale_net_to_output (poseExtractorCaffe.cpp:306-311)
        net_out_w, net_out_h = plan.net_input_sizes[0]
        s_prod_to_net = scaler.resize_get_scale_factor(
            (in_w, in_h), (net_out_w, net_out_h))
        net_size = (int(s_prod_to_net * in_w + 0.5),
                    int(s_prod_to_net * in_h + 0.5))
        scale_net_to_output = scaler.resize_get_scale_factor(
            net_size, (in_w, in_h))
        nms_offset = float(0.5 / scale_net_to_output)

        fn = self._device_fn((in_h, in_w), plan, nms_offset)
        img = jnp.asarray(np.ascontiguousarray(image, np.float32)[None])
        injected = None
        if net_output is not None:
            injected = jnp.asarray(
                np.ascontiguousarray(net_output, np.float32)[None])
        merged, peaks_dev, scores_dev, full_low = fn(self.model.params, img,
                                                     injected)

        peaks_np = np.asarray(peaks_dev)[0]
        scores_np = np.asarray(scores_dev)[0]
        keypoints, person_scores = self.assemble(peaks_np, scores_np,
                                                 scale_net_to_output)
        return PosePrediction(
            keypoints=keypoints, scores=person_scores,
            heatmaps=np.asarray(full_low)[0] if keep_heatmaps else None,
            peaks=peaks_np,
            scale_net_to_output=scale_net_to_output,
            net_output_size=(net_out_w, net_out_h),
            scale_input_to_net=tuple(plan.scale_input_to_net),
            net_input_sizes=tuple(plan.net_input_sizes))
