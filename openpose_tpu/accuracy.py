"""Closed-loop synthetic COCO accuracy harness.

Measures AP of the REAL user path without trained weights: synthetic scenes
with known keypoints are rendered to net-output tensors ON DEVICE
(train.make_targets), injected into the sharded inference program in place of
the CNN (the reference's Datum::poseNetOutput hook, datum.hpp:212-217), and
the standard device->host tail runs unchanged — NMS + PAF scoring in the
sharded program, greedy assembly on the host pool, CocoJsonSaver, and the
pycocotools-exact evaluator.  This closes the loop the reference closes with
scripts/tests/pose_accuracy_coco_val.sh:14-30: any regression in peak
refinement, PAF scoring, assembly, COCO reordering, or evaluation moves the
reported AP.

The moment real weights exist, scripts/coco_val.py measures true COCO AP with
the same saver + evaluator; this harness pins everything downstream of the
CNN meanwhile, and the noise sweep characterizes robustness of the post chain
to imperfect heatmaps.
"""

from __future__ import annotations

import concurrent.futures
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openpose_tpu import scenes, train
from openpose_tpu.io import coco_eval, json_io
from openpose_tpu.models import zoo
from openpose_tpu.ops import paf
from openpose_tpu.params import PoseModel
from openpose_tpu.parallel.inference import ShardedPoseInference
from openpose_tpu.pose.extractor import PoseExtractor


def synthetic_coco_eval(n_images: int = 64,
                        net_hw: Tuple[int, int] = (368, 656),
                        people_range: Tuple[int, int] = (1, 4),
                        noise: float = 0.0,
                        kp_jitter: float = 0.0,
                        batch: int = 8,
                        seed: int = 0,
                        mesh=None,
                        model=None,
                        assembly_workers: int = 4) -> Dict[str, float]:
    """Run the closed loop; returns {AP, AP50, AP75, AR, n_images, noise}.

    noise: stddev of SPATIALLY CORRELATED noise added to every net-output
    channel on device (white noise rendered at 1/4 the map resolution and
    bicubic-upsampled — CNN prediction error is smooth, so white pixel
    noise would be an unrealistically adversarial model; heatmap peaks have
    amplitude 1.0).
    kp_jitter: stddev (input px) of Gaussian displacement applied to the
    RENDERED keypoints only — the ground truth keeps the true positions, so
    this sweeps AP against controlled localization error of the "CNN".
    """
    from openpose_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    if model is None:
        model = zoo.load_pose_model(PoseModel.BODY_25)
    info = model.info
    net_h, net_w = net_hw
    pairs, map_idx = paf.pair_tables(info)
    pairs_j, map_idx_j = jnp.asarray(pairs), jnp.asarray(map_idx)

    inference = ShardedPoseInference(
        model, mesh=mesh, net_hw=net_hw, net_bypass=True,
        compute_dtype=jnp.float32)
    extractor = PoseExtractor(model, compute_dtype=jnp.float32)
    if batch % inference.data_parallelism:
        batch = inference.data_parallelism * max(
            1, batch // inference.data_parallelism)

    num_parts, num_ch = info.num_parts, info.heatmap_channels

    from openpose_tpu.ops import resize as resize_ops

    @jax.jit
    def render(kp_batch, noise_key, noise_scale, jitter_scale):
        k1, k2 = jax.random.split(noise_key)
        kp = kp_batch.at[..., :2].add(
            jitter_scale * jax.random.normal(k1, kp_batch[..., :2].shape))
        out = train.make_targets(kp, pairs_j, map_idx_j,
                                 (net_h, net_w), num_parts, num_ch)
        b, h8, w8, c = out.shape
        low = jax.random.normal(k2, (b, max(1, h8 // 4), max(1, w8 // 4), c))
        return out + noise_scale * resize_ops.resize_bicubic(low, (h8, w8))

    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    max_people = people_range[1]
    saver = json_io.CocoJsonSaver()
    gts: List[Dict] = []
    pool = concurrent.futures.ThreadPoolExecutor(assembly_workers)
    futures = []

    def assemble(idx, peaks_i, scores_i):
        kp, sc = extractor.assemble(peaks_i, scores_i, 1.0)
        return idx, kp, sc

    try:
        for start in range(0, n_images, batch):
            ids = [start + i for i in range(batch)]
            kp_batch = np.zeros((batch, max_people, info.num_parts, 3),
                                np.float32)
            for bi, image_id in enumerate(ids):
                if image_id >= n_images:
                    continue                 # padded tail: zero people
                people = scenes.random_people(
                    rng, rng.randint(people_range[0], people_range[1] + 1),
                    (net_h, net_w))
                kp_batch[bi, :people.shape[0]] = people
                gts.extend(scenes.coco_ground_truth(people, image_id))
            key, sub = jax.random.split(key)
            net_out = render(jnp.asarray(kp_batch), sub, float(noise),
                             float(kp_jitter))
            peaks, scores = inference.fetch(*inference(net_out))
            for bi, image_id in enumerate(ids):
                if image_id >= n_images:
                    continue
                futures.append(pool.submit(assemble, image_id,
                                           peaks[bi], scores[bi]))
        for fut in futures:
            image_id, kp, sc = fut.result()
            if kp.size:
                saver.record(kp, sc, image_id)
    finally:
        pool.shutdown(wait=True)

    detections = saver.entries[json_io.VARIANT_BODY]
    metrics = coco_eval.evaluate(detections, gts)
    metrics.update(n_images=n_images, noise=noise, kp_jitter=kp_jitter,
                   n_detections=len(detections), n_gt=len(gts))
    return metrics


def synthetic_topdown_eval(kind: str = "face",
                           n_frames: int = 16,
                           frame_hw: Tuple[int, int] = (368, 656),
                           people_range: Tuple[int, int] = (1, 3),
                           net_size: int = 368,
                           sigma: float = 7.0,
                           batch: int = 8,
                           seed: int = 0,
                           mesh=None) -> Dict[str, float]:
    """Closed-loop face/hand localization accuracy through the REAL
    top-down device program (crop geometry -> decode -> map-back).

    Mirrors synthetic_coco_eval for the top-down stage: body keypoints
    from random scenes produce face/hand rectangles exactly as the
    whole-body cascade does (detect_faces/detect_hands from pose keypoints,
    faceDetector.cpp:37-75), ground-truth part locations are drawn inside
    each rectangle, rendered as net-output Gaussians in CROP space (same
    grid convention as training targets), injected into ShardedTopDown's
    decode program in place of the CNN, and mapped back to frame pixels by
    the standard path (warp.map_back; faceExtractorCaffe.cpp:230-310 /
    mirrored left hands handExtractorCaffe.cpp:44-75).  Any regression in
    rect_to_transform, the 8x upsample decode, mirror handling, or map-back
    moves the reported error.

    Returns {kind, rmse_px, max_err_px, pck05, n_instances, n_parts}:
    rmse in FRAME pixels over every valid part, PCK@0.05 = fraction of
    parts within 5% of the rect side.
    """
    from openpose_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from openpose_tpu.face.detector import detect_faces
    from openpose_tpu.hand.detector import detect_hands
    from openpose_tpu.ops import warp
    from openpose_tpu.parallel.inference import ShardedTopDown
    from openpose_tpu.params import (
        FACE_NUMBER_PARTS, HAND_NUMBER_PARTS)

    is_face = kind == "face"
    num_parts = FACE_NUMBER_PARTS if is_face else HAND_NUMBER_PARTS
    cap = people_range[1] * (1 if is_face else 2)
    model = (zoo.load_face_model() if is_face else zoo.load_hand_model())
    topdown = ShardedTopDown(model, mesh=mesh, net_size=net_size,
                             people_cap=cap, compute_dtype=jnp.float32)

    s8 = net_size // 8
    # map px m <-> crop coord (m + 0.5)*8 - 0.5 (train.make_targets grid;
    # the 8x half-pixel-center bicubic upsample then lands upsampled px j
    # exactly on crop coord j, so argmax recovers the rendered location)
    grid = (np.arange(s8, dtype=np.float32) + 0.5) * 8.0 - 0.5

    rng = np.random.RandomState(seed)
    errors: List[np.ndarray] = []
    rel_errors: List[np.ndarray] = []
    n_instances = 0
    fh, fw = frame_hw

    for start in range(0, n_frames, batch):
        maps = np.zeros((batch, cap, s8, s8, num_parts), np.float32)
        gt: List[List[Tuple[int, np.ndarray, Tuple, float]]] = []
        for bi in range(batch):
            rows = []
            if start + bi < n_frames:
                people = scenes.random_people(
                    rng, rng.randint(people_range[0], people_range[1] + 1),
                    (fh, fw))
                if is_face:
                    rects = [(r, False)
                             for r in detect_faces(people, PoseModel.BODY_25)]
                else:
                    rects = []
                    for left, right in detect_hands(people,
                                                    PoseModel.BODY_25):
                        rects.append((left, True))
                        rects.append((right, False))
                for slot, (rect, mirror) in enumerate(rects[:cap]):
                    if min(rect[2], rect[3]) <= 1 or rect[2] * rect[3] <= 10:
                        continue
                    tr = warp.rect_to_transform(rect, net_size, mirror)
                    # ground-truth parts inside the central 70% of the rect
                    x0, y0, rw, rh = rect
                    pts = np.stack([
                        x0 + rw * rng.uniform(0.15, 0.85, num_parts),
                        y0 + rh * rng.uniform(0.15, 0.85, num_parts)],
                        axis=-1).astype(np.float32)
                    crop_pts = warp.map_forward(pts, tr)
                    dx2 = (grid[None, :] - crop_pts[:, 0][:, None]) ** 2
                    dy2 = (grid[None, :] - crop_pts[:, 1][:, None]) ** 2
                    d2 = dy2[:, :, None] + dx2[:, None, :]  # [parts, y, x]
                    maps[bi, slot] = np.exp(
                        -d2 / (2.0 * sigma * sigma)).transpose(1, 2, 0)
                    rows.append((slot, pts, tr, max(rw, rh)))
                    n_instances += 1
            gt.append(rows)
        peaks = np.asarray(topdown(None, None, net_output=maps))
        for bi, rows in enumerate(gt):
            for slot, pts, tr, side in rows:
                xy = warp.map_back(peaks[bi, slot, :num_parts, :2], tr)
                err = np.linalg.norm(xy - pts, axis=-1)
                errors.append(err)
                rel_errors.append(err / max(side, 1.0))

    err = np.concatenate(errors) if errors else np.zeros(1)
    rel = np.concatenate(rel_errors) if rel_errors else np.ones(1)
    return {
        "kind": kind,
        "rmse_px": float(np.sqrt((err ** 2).mean())),
        "max_err_px": float(err.max()),
        "pck05": float((rel < 0.05).mean()),
        "n_instances": n_instances,
        "n_parts": int(err.size),
    }


def train_to_ap(steps: int = 1500,
                image_size: Tuple[int, int] = (184, 328),
                batch: int = 8,
                learning_rate: float = 1e-4,
                n_eval: int = 16,
                people_range: Tuple[int, int] = (1, 3),
                seed: int = 0,
                checkpoint_dir: str = "",
                lr_schedule: str = "constant",
                target_sigma: float = 7.0,
                verbose: bool = True) -> Dict[str, float]:
    """Train BODY_25 from scratch on rendered synthetic scenes, then measure
    COCO AP of the trained net through the FULL pipeline on held-out scenes.

    Turns "loss decreases" into "training produces a net the pipeline can
    decode": train (train_loop.train, sharded step) -> held-out rendered
    images -> real CNN forward -> NMS -> PAF -> assembly -> CocoJsonSaver ->
    pycocotools-exact AP.  The synthetic drawing domain (color-coded joints
    and limbs) is learnable by the CPM/PAF architecture in O(10^3) steps.
    """
    import tempfile
    import jax
    from openpose_tpu import train_loop
    from openpose_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    config = train_loop.TrainConfig(
        model=PoseModel.BODY_25, image_size=image_size, batch_size=batch,
        learning_rate=learning_rate, steps=steps, checkpoint_every=steps,
        checkpoint_dir=checkpoint_dir or tempfile.mkdtemp(prefix="t2ap_"),
        lr_schedule=lr_schedule, target_sigma=target_sigma)
    data = train_loop.synthetic_scene_iterator(
        config, seed=seed, people_range=people_range,
        prefetch_workers=2)
    train_stats: Dict[str, float] = {}
    state = train_loop.train(config, data, verbose=verbose,
                             stats_out=train_stats)
    params = jax.device_get(state.params)

    import dataclasses
    base = zoo.load_pose_model(PoseModel.BODY_25)
    trained = dataclasses.replace(base, params=params)
    extractor = PoseExtractor(trained, compute_dtype=jnp.float32)

    h, w = image_size
    rng = np.random.RandomState(seed + 1)            # held-out scenes
    saver = json_io.CocoJsonSaver()
    gts: List[Dict] = []
    hr = (max(80.0, h * 0.45), h * 0.9)
    for image_id in range(n_eval):
        people = scenes.random_people(
            rng, rng.randint(people_range[0], people_range[1] + 1),
            (h, w), height_range=hr, min_spacing=60.0)
        gts.extend(scenes.coco_ground_truth(people, image_id))
        img = scenes.render_scene_image(people, (h, w), rng=rng)
        pred = extractor.forward(img.astype(np.float32),
                                 net_resolution=(w, h))
        if pred.keypoints.size:
            saver.record(pred.keypoints, pred.scores, image_id)
    metrics = coco_eval.evaluate(saver.entries[json_io.VARIANT_BODY], gts)
    metrics.update(steps=steps, n_eval=n_eval, lr_schedule=lr_schedule,
                   target_sigma=target_sigma, **train_stats)
    # device-resident step time (the host-fed img_s above bundles the
    # per-step host->device upload)
    try:
        metrics.update(train_loop.device_step_probe(config))
    except Exception:
        pass
    return metrics


def noise_sweep(levels=(0.0, 0.1, 0.2, 0.4), **kw) -> List[Dict[str, float]]:
    """AP at each (correlated) map-noise level."""
    model = kw.pop("model", None) or zoo.load_pose_model(PoseModel.BODY_25)
    return [synthetic_coco_eval(noise=lv, model=model, **kw)
            for lv in levels]


def jitter_sweep(levels=(0.0, 2.0, 4.0, 8.0), **kw) -> List[Dict[str, float]]:
    """AP at each keypoint-localization-error level (px)."""
    model = kw.pop("model", None) or zoo.load_pose_model(PoseModel.BODY_25)
    return [synthetic_coco_eval(kp_jitter=lv, model=model, **kw)
            for lv in levels]
