"""Whole-body (pose + face + both hands) over a sharded frame-batch.

The reference replicates the full cascade per GPU and runs it per frame
(configureThreadManager worker chain, wrapperAuxiliary.hpp:324-337); here
it is three sharded device programs with host geometry
between them:

  frames [B, H, W, 3] uint8, sharded over the mesh data axis
    -> body program   (per-scale resize -> CNN -> merge -> NMS -> PAF)
    -> host: greedy assembly + face/hand rectangle geometry per frame
    -> face program   (vmapped crop -> CNN -> argmax)  \\  one batched
    -> hand program   (left crops mirrored)            /  forward each
    -> host: map crop keypoints back to frame coordinates

Every stage shards the batch dimension only, so all three programs are
collective-free under pure data parallelism (tests/test_whole_body.py
asserts this from the HLO like test_data_parallel_is_collective_free).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from openpose_tpu.face.detector import detect_faces
from openpose_tpu.hand.detector import detect_hands
from openpose_tpu.models.zoo import Model
from openpose_tpu.ops import warp
from openpose_tpu.params import (
    FACE_NUMBER_PARTS, HAND_NUMBER_PARTS, PoseModel)
from openpose_tpu.parallel.inference import (
    ShardedPoseInference, ShardedTopDown)
from openpose_tpu.pose.extractor import PoseExtractor


@dataclasses.dataclass
class WholeBodyResult:
    """Per-frame whole-body keypoints, all in frame pixel coordinates."""

    pose_keypoints: np.ndarray          # [people, parts, 3]
    pose_scores: np.ndarray             # [people]
    face_keypoints: Optional[np.ndarray] = None        # [people, 70, 3]
    hand_left_keypoints: Optional[np.ndarray] = None   # [people, 21, 3]
    hand_right_keypoints: Optional[np.ndarray] = None  # [people, 21, 3]


class ShardedWholeBody:
    """Batched whole-body cascade over one shared device mesh."""

    def __init__(self, pose_model: Model,
                 face_model: Optional[Model] = None,
                 hand_model: Optional[Model] = None,
                 mesh=None, frame_hw: Tuple[int, int] = (368, 656),
                 net_hw: Tuple[int, int] = (368, 656),
                 people_cap: int = 8,
                 scale_number: int = 1, scale_gap: float = 0.25,
                 max_peaks: int = 127,
                 face_net_size: int = 368, hand_net_size: int = 368,
                 compute_dtype=None, **body_kwargs):
        import jax.numpy as jnp
        dtype = compute_dtype if compute_dtype is not None else jnp.bfloat16
        self.pose_model = pose_model
        self.people_cap = people_cap
        self.body = ShardedPoseInference(
            pose_model, mesh=mesh, net_hw=net_hw, max_peaks=max_peaks,
            compute_dtype=dtype, scale_number=scale_number,
            scale_gap=scale_gap, frame_hw=frame_hw, **body_kwargs)
        mesh = self.body.mesh
        self.mesh = mesh
        self.face = ShardedTopDown(
            face_model, mesh, face_net_size, people_cap, dtype) \
            if face_model is not None else None
        # hands: 2 crops per person (left mirrored + right)
        self.hand = ShardedTopDown(
            hand_model, mesh, hand_net_size, 2 * people_cap, dtype) \
            if hand_model is not None else None
        self._extractor = PoseExtractor(pose_model, max_peaks=max_peaks,
                                        compute_dtype=dtype)
        self._pose_enum = PoseModel(pose_model.info.name)

    # ------------------------------------------------------------------ #
    def __call__(self, frames: np.ndarray,
                 net_output=None) -> List[WholeBodyResult]:
        """frames [B, H, W, 3] BGR uint8 (B divisible by the data axis).

        net_output: optional [B, net_h/8, net_w/8, C] tensor injected in
        place of the body CNN (requires a net_bypass=True body — the
        Datum::poseNetOutput hook through the whole cascade: the face/hand
        stages still crop from `frames` using the people assembled from
        the injected maps)."""
        frames = np.asarray(frames)
        b = frames.shape[0]
        if net_output is not None:
            if not self.body.net_bypass:
                raise ValueError("net_output injection needs a "
                                 "net_bypass=True body stage")
            out = self.body(np.asarray(net_output))
        else:
            out = self.body(frames)
        peaks, scores = self.body.fetch(*out)
        s_n2o = self.body.scale_net_to_output

        results: List[WholeBodyResult] = []
        for i in range(b):
            kp, person_scores = self._extractor.assemble(
                peaks[i], scores[i], s_n2o)
            if kp.shape[0] > self.people_cap:
                # KeepTopNPeople (src/openpose/core/keepTopNPeople.cpp)
                order = np.argsort(person_scores)[::-1][:self.people_cap]
                kp, person_scores = kp[order], person_scores[order]
            results.append(WholeBodyResult(kp, person_scores))

        if self.face is not None:
            self._run_topdown(
                frames, results, self.face,
                lambda kp: [(r, False) for r in
                            detect_faces(kp, self._pose_enum)],
                FACE_NUMBER_PARTS, "face")
        if self.hand is not None:
            def hand_rects(kp):
                pairs = detect_hands(kp, self._pose_enum)
                flat = []
                for left, right in pairs:
                    flat.append((left, True))     # left hand mirrored
                    flat.append((right, False))
                return flat
            self._run_topdown(frames, results, self.hand, hand_rects,
                              HAND_NUMBER_PARTS, "hand")
        return results

    # ------------------------------------------------------------------ #
    def _run_topdown(self, frames, results, topdown, rect_fn,
                     num_parts, kind: str) -> None:
        b = frames.shape[0]
        cap = topdown.people_cap
        transforms = np.tile(np.asarray(topdown.INACTIVE, np.float32),
                             (b, cap, 1))
        active: List[List[Tuple[int, object]]] = []
        slot_counts: List[int] = []
        any_active = False
        for i, res in enumerate(results):
            rows = []
            rects = rect_fn(res.pose_keypoints)
            slot_counts.append(len(rects))
            for slot, (rect, mirror) in enumerate(rects[:cap]):
                if min(rect[2], rect[3]) > 1 and rect[2] * rect[3] > 10:
                    tr = warp.rect_to_transform(rect, topdown.net_size,
                                                mirror)
                    transforms[i, slot] = tr
                    rows.append((slot, tr))
                    any_active = True
            active.append(rows)
        if not any_active:
            self._store(results, kind, [
                np.zeros((n, num_parts, 3), np.float32)
                for n in slot_counts])
            return
        peaks = np.asarray(topdown(frames, transforms))   # [B, cap, C, 3]
        per_frame = []
        for i, res in enumerate(results):
            n_slots = slot_counts[i]
            kp = np.zeros((n_slots, num_parts, 3), np.float32)
            for slot, tr in active[i]:
                if slot >= n_slots:
                    continue
                raw = peaks[i, slot, :num_parts]
                xy = warp.map_back(raw[:, :2], tr)
                kp[slot, :, 0] = xy[:, 0]
                kp[slot, :, 1] = xy[:, 1]
                kp[slot, :, 2] = raw[:, 2]
            per_frame.append(kp)
        self._store(results, kind, per_frame)

    @staticmethod
    def _store(results, kind: str, per_frame) -> None:
        for res, kp in zip(results, per_frame):
            if kind == "face":
                res.face_keypoints = kp
            else:
                # interleaved (left, right) per person
                n = kp.shape[0] // 2
                res.hand_left_keypoints = kp[0::2][:n]
                res.hand_right_keypoints = kp[1::2][:n]
