"""Training driver: COCO-keypoint data -> sharded train steps -> checkpoints.

Completes the training story around openpose_tpu.train (the CPM/PAF
objective): a data pipeline turning COCO person-keypoint annotations into
(image, keypoint) batches, a sharded step over the (data, model) mesh, and
periodic .npz checkpoints.  The reference ships no trainer (openpose_train
is a separate Caffe repo); this gives the framework a first-class one.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from openpose_tpu.params import PoseModel, POSE_MODEL_INFO

# COCO 17 -> model part index (BODY_25/COCO_18 share the mapping below for
# the COCO-subset joints; neck is synthesized as the shoulder midpoint, the
# standard CPM training recipe).
_COCO17_TO_BODY25 = {
    0: 0, 1: 16, 2: 15, 3: 18, 4: 17, 5: 5, 6: 2, 7: 6, 8: 3, 9: 7, 10: 4,
    11: 12, 12: 9, 13: 13, 14: 10, 15: 14, 16: 11}


def coco_to_model_keypoints(coco_kp: np.ndarray, model: PoseModel,
                            max_people: int) -> np.ndarray:
    """coco_kp [people, 17, 3] -> [max_people, parts, 3] model layout."""
    info = POSE_MODEL_INFO[model]
    out = np.zeros((max_people, info.num_parts, 3), np.float32)
    n = min(coco_kp.shape[0], max_people)
    for person in range(n):
        kp = coco_kp[person]
        for ci, mi in _COCO17_TO_BODY25.items():
            if mi < info.num_parts and kp[ci, 2] > 0:
                out[person, mi] = (kp[ci, 0], kp[ci, 1], 1.0)
        # neck = shoulder midpoint (parts 2 and 5)
        if info.num_parts > 1 and kp[5, 2] > 0 and kp[6, 2] > 0:
            out[person, 1] = ((kp[5, 0] + kp[6, 0]) / 2,
                              (kp[5, 1] + kp[6, 1]) / 2, 1.0)
        # midhip for BODY_25 (part 8) from hips 11/12
        if info.num_parts >= 25 and kp[11, 2] > 0 and kp[12, 2] > 0:
            out[person, 8] = ((kp[11, 0] + kp[12, 0]) / 2,
                              (kp[11, 1] + kp[12, 1]) / 2, 1.0)
    return out


@dataclasses.dataclass
class TrainConfig:
    model: PoseModel = PoseModel.BODY_25
    image_size: Tuple[int, int] = (368, 368)   # (h, w)
    batch_size: int = 8
    max_people: int = 8
    learning_rate: float = 1e-4
    steps: int = 1000
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    model_parallel: int = 1
    # "constant" or "cosine" (linear warmup then cosine decay to 1% of
    # peak — the standard large-batch recipe; constant-LR Adam plateaus
    # with residual localization error on the sub-pixel refinement scale).
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    # Confidence-map Gaussian stddev in input px (CMU openpose_train's
    # sigma; sharper targets sharpen the learned peaks and cut the
    # decoded localization error).
    target_sigma: float = 7.0


def coco_data_iterator(images_dir: str, annotations_json: str,
                       config: TrainConfig, seed: int = 0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images [B,H,W,3] f32 normalized-ready BGR, keypoints
    [B,people,parts,3] in resized-image coords)."""
    import cv2
    with open(annotations_json) as f:
        coco = json.load(f)
    by_image: Dict[int, List[dict]] = {}
    for ann in coco["annotations"]:
        if ann.get("num_keypoints", 0) > 0:
            by_image.setdefault(ann["image_id"], []).append(ann)
    id_to_file = {img["id"]: img["file_name"] for img in coco["images"]}
    image_ids = [i for i in by_image if i in id_to_file]
    rng = np.random.RandomState(seed)
    h, w = config.image_size
    while True:
        batch_imgs = np.zeros((config.batch_size, h, w, 3), np.float32)
        batch_kps = np.zeros(
            (config.batch_size, config.max_people,
             POSE_MODEL_INFO[config.model].num_parts, 3), np.float32)
        for b in range(config.batch_size):
            image_id = image_ids[rng.randint(len(image_ids))]
            img = cv2.imread(str(pathlib.Path(images_dir)
                                 / id_to_file[image_id]))
            if img is None:
                continue
            sy, sx = h / img.shape[0], w / img.shape[1]
            batch_imgs[b] = cv2.resize(img, (w, h)).astype(np.float32)
            kp17 = np.stack([
                np.asarray(a["keypoints"], np.float32).reshape(17, 3)
                for a in by_image[image_id]])
            kp = coco_to_model_keypoints(kp17, config.model,
                                         config.max_people)
            kp[..., 0] *= sx
            kp[..., 1] *= sy
            batch_kps[b] = kp
        yield batch_imgs, batch_kps


def synthetic_scene_iterator(config: TrainConfig, seed: int = 0,
                             people_range: Tuple[int, int] = (1, 3),
                             prefetch_workers: int = 0
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield rendered synthetic scenes (images + keypoints) endlessly.

    The synthetic-domain counterpart of coco_data_iterator: skeletons drawn
    as color-coded joints/limbs (scenes.render_scene_image) with matching
    keypoint annotations — enough to demonstrate that training produces a
    net the full pipeline can decode to AP (see accuracy.train_to_ap).

    prefetch_workers > 0: render batches in that many background threads
    (cv2/numpy release the GIL) with per-worker seeds and hand them over a
    bounded queue — at 368x656 one thread renders ~600 ms/batch, slower
    than the device step, so an unprefetched trainer is input-bound.  Batch
    ORDER becomes interleave-dependent; content is still seed-derived."""
    from openpose_tpu import scenes
    h, w = config.image_size
    n_parts = POSE_MODEL_INFO[config.model].num_parts
    hr = (max(80.0, h * 0.45), h * 0.9)

    def gen(worker_seed: int):
        rng = np.random.RandomState(worker_seed)
        while True:
            imgs = np.zeros((config.batch_size, h, w, 3), np.float32)
            kps = np.zeros(
                (config.batch_size, config.max_people, n_parts, 3),
                np.float32)
            for b in range(config.batch_size):
                people = scenes.random_people(
                    rng, rng.randint(people_range[0], people_range[1] + 1),
                    (h, w), height_range=hr, min_spacing=60.0)
                if n_parts < 25:
                    people = people[:, :n_parts]
                kps[b, :people.shape[0]] = people
                imgs[b] = scenes.render_scene_image(people, (h, w), rng=rng)
            yield imgs, kps

    if prefetch_workers <= 0:
        yield from gen(seed)
        return

    import queue as queue_mod
    import threading
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2 * prefetch_workers)
    stop = threading.Event()

    def worker(worker_seed: int):
        it = gen(worker_seed)
        while not stop.is_set():
            try:
                q.put(next(it), timeout=0.5)
            except queue_mod.Full:
                continue

    threads = [threading.Thread(target=worker, args=(seed + 1000 * i,),
                                daemon=True)
               for i in range(prefetch_workers)]
    for t in threads:
        t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


def device_step_probe(config: TrainConfig, n_lo: int = 2, n_hi: int = 10,
                      reps: int = 3) -> dict:
    """Pure device-resident chained train-step timing.

    Threads the TRAIN STATE itself through the lax.fori_loop carry, so the
    backward pass and the optimizer update are live computation — a
    loss-only carry lets XLA dead-code-eliminate the whole backward, which
    made the round-4 probe a forward-only measurement (the same DCE class
    utils/benchmark.fold closes for inference chains).  Keypoints are
    perturbed by the carry so target rendering re-executes per iteration
    like real training.

    Returns {device_step_ms, device_img_s, device_train_tflops,
    device_train_mfu} with the 3x-forward FLOPs convention; the step runs
    in f32 at DEFAULT precision, so MFU is against the device's TF32 peak
    (an unknown device raises).  The host-fed img/s of `train` bundles the
    per-step upload; this does not.
    """
    import time as _time
    import jax
    import jax.numpy as jnp
    import optax
    from openpose_tpu import train as train_mod
    from openpose_tpu.models import graph
    from openpose_tpu.ops import paf as paf_ops
    from openpose_tpu.ops.resize import normalize_vgg
    from openpose_tpu.utils.benchmark import device_peak

    info = POSE_MODEL_INFO[config.model]
    spec = graph.load_spec(info.spec)
    optimizer = optax.adam(config.learning_rate)
    state = train_mod.init_train_state(spec, optimizer,
                                       jax.random.PRNGKey(0))
    pairs = jnp.asarray(paf_ops.pair_tables(info)[0])
    map_idx = jnp.asarray(paf_ops.pair_tables(info)[1])
    base_step = train_mod.make_train_step(spec, optimizer)
    h, w = config.image_size
    rng = np.random.RandomState(0)
    images = jnp.asarray(rng.randint(
        0, 255, (config.batch_size, h, w, 3)).astype(np.uint8))
    kp = np.zeros((config.batch_size, 3, info.num_parts, 3), np.float32)
    kp[..., 0] = rng.uniform(40, w - 40, kp.shape[:-1])
    kp[..., 1] = rng.uniform(40, h - 40, kp.shape[:-1])
    kp[..., 2] = 1.0
    keypoints = jnp.asarray(kp)

    @jax.jit
    def run(n, state):
        def body(_, carry):
            state, c = carry
            targets = train_mod.make_targets(
                keypoints + c * 1e-12, pairs, map_idx, (h, w),
                info.num_parts, info.heatmap_channels,
                sigma=config.target_sigma)
            x = normalize_vgg(images.astype(jnp.float32) + c * 1e-12)
            state, loss = base_step(state, x, targets)
            return (state, c + loss * 1e-12)
        return jax.lax.fori_loop(0, n, body, (state, jnp.float32(0.0)))

    _, c = run(jnp.int32(n_hi), state)       # compile + warm
    float(c)

    def timed(n):
        best = float("inf")
        for _ in range(reps):
            t0 = _time.perf_counter()
            _, c = run(jnp.int32(n), state)
            float(c)                          # scalar readback = true sync
            best = min(best, _time.perf_counter() - t0)
        return best

    ms = max(timed(n_hi) - timed(n_lo), 1e-9) / (n_hi - n_lo) * 1e3
    fwd_gflops = sum(graph.count_flops(spec, (h, w)).values()) / 1e9
    img_s = config.batch_size / ms * 1e3
    tflops = 3.0 * fwd_gflops * img_s / 1e3
    return {"device_step_ms": round(ms, 2),
            "device_img_s": round(img_s, 1),
            "device_train_tflops": round(tflops, 1),
            "device_train_mfu": round(tflops / device_peak("tf32"), 3)}


def train(config: TrainConfig, data: Iterator, verbose: bool = True,
          stats_out: Optional[dict] = None):
    """Run the training loop on the available devices; returns final state.

    stats_out: if given, filled with steady-state throughput/roofline
    numbers ({img_s, step_ms, train_tflops, fwd_gflops_img})
    measured from step 1 onward (step 0 pays the compile)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from openpose_tpu import train as train_mod
    from openpose_tpu.models import checkpoint, graph
    from openpose_tpu.ops import paf as paf_ops
    from openpose_tpu.ops.resize import normalize_vgg
    from openpose_tpu.parallel import mesh as mesh_lib

    info = POSE_MODEL_INFO[config.model]
    spec = graph.load_spec(info.spec)
    if config.lr_schedule == "cosine":
        lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=config.learning_rate,
            warmup_steps=min(config.warmup_steps, max(1, config.steps // 10)),
            decay_steps=config.steps,
            end_value=config.learning_rate * 0.01)
    else:
        lr = config.learning_rate
    optimizer = optax.adam(lr)
    state = train_mod.init_train_state(spec, optimizer,
                                       jax.random.PRNGKey(0))
    mesh = mesh_lib.make_mesh(model=config.model_parallel)
    p_shard = mesh_lib.param_sharding(mesh, state.params)
    state = train_mod.TrainState(
        jax.device_put(state.params, p_shard),
        jax.device_put(state.opt_state, jax.tree.map(
            lambda _: mesh_lib.replicated(mesh), state.opt_state,
            is_leaf=lambda x: hasattr(x, "shape"))),
        jax.device_put(state.step, mesh_lib.replicated(mesh)))

    pairs = jnp.asarray(paf_ops.pair_tables(info)[0])
    map_idx = jnp.asarray(paf_ops.pair_tables(info)[1])
    h, w = config.image_size
    base_step = train_mod.make_train_step(spec, optimizer)

    def full_step(state, images, keypoints):
        targets = train_mod.make_targets(
            keypoints, pairs, map_idx, (h, w), info.num_parts,
            info.heatmap_channels, sigma=config.target_sigma)
        # images arrive uint8 (quarter the host->device bytes; the cast
        # fuses into normalize like the inference path)
        return base_step(state, normalize_vgg(images.astype(jnp.float32)),
                         targets)

    batch_sh = mesh_lib.batch_sharding(mesh)
    step_fn = jax.jit(full_step, donate_argnums=(0,),
                      in_shardings=(None, batch_sh, batch_sh))

    ckpt_dir = pathlib.Path(config.checkpoint_dir)
    t0 = time.time()
    t_steady = None                       # set after step 0 (compile) retires
    with mesh:
        for step in range(config.steps):
            images, keypoints = next(data)
            if images.dtype != np.uint8:
                # rint, not truncation: renderers emit fractional pixels
                # and plain astype would add a ~-0.5 intensity bias
                images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
            state, loss = step_fn(state, jnp.asarray(images),
                                  jnp.asarray(keypoints))
            if step == 0:
                jax.block_until_ready(loss)
                t_steady = time.time()
            if verbose and (step % 50 == 0 or step == config.steps - 1):
                print(f"step {step}: loss {float(loss):.6f} "
                      f"({(step + 1) * config.batch_size / (time.time() - t0):.1f} img/s)")
            if (step + 1) % config.checkpoint_every == 0 \
                    or step == config.steps - 1:
                path = ckpt_dir / f"{info.name}_step{step + 1}.npz"
                checkpoint.save(str(path), jax.device_get(state.params))
                if verbose:
                    print(f"saved {path}")
        jax.block_until_ready(state.step)
    if hasattr(data, "close"):
        # stop prefetch render threads: they are daemons, but left running
        # they burn CPU through any subsequent phase (e.g. train_to_ap's
        # eval) until interpreter exit
        data.close()
    if stats_out is not None and config.steps > 1 and t_steady is not None:
        dt = time.time() - t_steady
        n_steady = config.steps - 1
        img_s = n_steady * config.batch_size / dt
        fwd_gflops = sum(graph.count_flops(
            spec, config.image_size).values()) / 1e9
        # fwd + bwd(params) + bwd(activations) = 3x fwd MACs — the standard
        # training-FLOPs accounting (scaling-book convention).
        tflops = 3.0 * fwd_gflops * img_s / 1e3
        stats_out.update(
            img_s=round(img_s, 1), step_ms=round(1e3 * dt / n_steady, 2),
            fwd_gflops_img=round(fwd_gflops, 1),
            train_tflops=round(tflops, 1))
    return state
