#!/usr/bin/env python3
"""Smoke test of the BODY_25 system on the GPU, through the user entry points.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the multi-card path only

One card (every mesh is ``jax.devices()[:1]``), in order, each phase raising
on failure:

1. device: the first JAX device must be a GPU; prints the card's name and
   power limit, its ``device_kind`` and the compile-cache directory.
2. cnn: BODY_25 ``graph.forward`` at 368x656 with seeded random weights, on
   the GPU in bf16 and in f32 at HIGHEST precision, each compared with the
   same forward in f32 at HIGHEST on the CPU (relative L2 error).
3. body: ``ShardedPoseInference`` at 368x656, batch 8, 127 peak slots:
   (a) net-output injection of 8 rendered people per frame, fetched,
   assembled on the host and written as people JSON: every person found,
   every keypoint within 3 px of where it was rendered; (b) the full
   program on raw uint8 frames (random weights saturate all 127 slots);
   (c) the program's post chain on the standalone CNN output of (b)'s
   frames (net-output injection, 127 saturated slots) against the plain
   gather reference ``paf.paf_scores`` on the materialized
   ``upsample_merge`` output.
4. whole body: ``Wrapper.process`` with face and hands on one 720p frame,
   then the batched ``ShardedWholeBody`` cascade on injected net outputs.
5. train: 5 steps of ``train.make_train_step`` on BODY_25 at 368x368,
   batch 8; the loss must be finite and lower after them.

Four cards: ``ShardedPoseInference`` on a 4-card ``data`` mesh against the
one-card program on the same 32 frames, and one training step on a
(data=2, model=2) mesh against the one-card step.

The last line of stdout is the JSON verdict
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
without a GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

NET_HW = (368, 656)          # BODY_25 headline resolution (BASELINE.md)
BATCH = 8
MAX_PEAKS = 127
TRAIN_HW = (368, 368)
PEOPLE = 8

# Relative L2 bounds of the GPU forward against the CPU f32 HIGHEST forward
# (seeded weights, 2 frames at 368x656).  f32 at HIGHEST is true fp32 on
# both sides, so only summation order differs: 4.4e-6 on an H100, bound at
# about 4x that.  bf16 rounds activations and weights (8-bit mantissa,
# ~4e-3 per rounding) through ~30 stacked convolutions with f32
# accumulation: 9.3e-3 on an H100, bound at about 2x that.
CNN_F32_HIGHEST_RTOL = 2e-5
CNN_BF16_RTOL = 2e-2
# PAF pair scores: the CPU test's elementwise bounds (tests/test_ops.py);
# scores sit next to the 0.05 sample threshold, so one sample that flips
# moves one entry a lot.  Stated as the fraction of entries within bounds.
PAF_RTOL, PAF_ATOL = 2e-3, 2e-4
PAF_MIN_FRACTION = 0.999
# Injected scenes: 8 people across a 656 px frame stand ~77 px apart, so
# they are kept short enough (110-170 px) that neighbours' limbs do not
# cross.  A keypoint is recovered within 3 px: the sigma-7 Gaussian sampled
# on the stride-8 grid puts the upsampled maximum up to ~1 px off the
# rendered point, and the reference adds +0.5 px to each refined coordinate
# (poseExtractorCaffe.cpp:317-318).
SCENE_HEIGHTS = (110.0, 170.0)
KEYPOINT_TOL_PX = 3.0
# One training step on the (2, 2) mesh vs one card, both at HIGHEST: only
# the order of fp32 sums differs (4 H100s: loss equal, update rel L2
# 6.3e-7; the bounds leave room for other reduction orders).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class Phases:
    """Timed phases; a phase that raises ends the run."""

    def __init__(self):
        self.times = {}

    def run(self, name, fn, *args, **kwargs):
        log(f"[phase] {name}: start")
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.times[name] = time.perf_counter() - t0
        log(f"[phase] {name}: ok in {self.times[name]:.1f} s")
        return out


# ---------------------------------------------------------------- device
def gpu_devices(count: int):
    """The first `count` devices; raises unless they are GPUs."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"{devices[0].platform!r})")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: {count} GPUs needed, "
                         f"{len(devices)} found")
    return devices[:count]


def phase_device(devices) -> None:
    from openpose_tpu.utils.compile_cache import enable_persistent_cache
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"device_kind: {devices[0].device_kind}; devices used: "
        f"{len(devices)}")
    log(f"compile cache: {enable_persistent_cache()}")


# ---------------------------------------------------------------- cnn
def phase_cnn(model, device, hw=NET_HW, batch=2, seed=0):
    """GPU bf16 and f32-HIGHEST forwards vs the CPU f32-HIGHEST forward."""
    import jax
    import jax.numpy as jnp
    from openpose_tpu.models import graph
    from openpose_tpu.ops import resize

    rng = np.random.RandomState(seed)
    x = resize.normalize_vgg(
        rng.uniform(0, 255, (batch,) + tuple(hw) + (3,)).astype(np.float32))
    x = np.asarray(x)

    def forward(dtype):
        return jax.jit(lambda p, im: graph.forward(p, model.spec, im, dtype))

    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(forward(jnp.float32)(
            jax.device_put(model.params, cpu), jax.device_put(x, cpu)))
        params_dev = jax.device_put(model.params, device)
        x_dev = jax.device_put(x, device)
        got_f32 = np.asarray(forward(jnp.float32)(params_dev, x_dev))
    got_bf16 = np.asarray(forward(jnp.bfloat16)(params_dev, x_dev))
    check(np.isfinite(got_f32).all() and np.isfinite(got_bf16).all(),
          "non-finite CNN output")
    e32, e16 = rel_l2(got_f32, want), rel_l2(got_bf16, want)
    log(f"cnn {hw[0]}x{hw[1]} batch {batch} out {got_f32.shape}: "
        f"rel L2 vs CPU f32 HIGHEST: f32 HIGHEST {e32:.3e} "
        f"(bound {CNN_F32_HIGHEST_RTOL:g}), bf16 {e16:.3e} "
        f"(bound {CNN_BF16_RTOL:g})")
    check(e32 <= CNN_F32_HIGHEST_RTOL, f"f32 HIGHEST rel L2 {e32:.3e}")
    check(e16 <= CNN_BF16_RTOL, f"bf16 rel L2 {e16:.3e}")


# ---------------------------------------------------------------- body
def render_people(model, hw, batch, people, seed,
                  height_range=SCENE_HEIGHTS):
    """([B, people, parts, 3] keypoints, [B, h/8, w/8, C] net outputs)."""
    import jax.numpy as jnp
    from openpose_tpu import scenes, train
    from openpose_tpu.ops import paf

    info = model.info
    rng = np.random.RandomState(seed)
    kp = np.stack([scenes.random_people(rng, people, hw, height_range)
                   [:, :info.num_parts] for _ in range(batch)])
    pairs, map_idx = paf.pair_tables(info)
    targets = train.make_targets(jnp.asarray(kp), jnp.asarray(pairs),
                                 jnp.asarray(map_idx), hw, info.num_parts,
                                 info.heatmap_channels)
    return kp, np.asarray(targets)


def match_people(found: np.ndarray, truth: np.ndarray) -> float:
    """Worst keypoint error (px) after matching every rendered person to the
    detected person nearest to it; inf when counts differ."""
    if found.shape[0] != truth.shape[0]:
        return float("inf")
    worst = 0.0
    for person in truth:
        d = np.linalg.norm(found[:, :, :2] - person[None, :, :2], axis=-1)
        best = int(np.argmin(d.mean(axis=1)))
        worst = max(worst, float(d[best].max()))
    return worst


def phase_body_injected(model, mesh, hw=NET_HW, batch=BATCH,
                        people=PEOPLE, seed=2):
    # Seed 2 draws 8 frames in which no limb of one person crosses another's
    # and nobody stands at the frame edge: separating such people is the
    # crowded-scene work of ROADMAP R7, not a bring-up check.
    from openpose_tpu.io import json_io
    from openpose_tpu.parallel.inference import ShardedPoseInference
    from openpose_tpu.pose.extractor import PoseExtractor

    kp, net_out = render_people(model, hw, batch, people, seed)
    inf = ShardedPoseInference(model, mesh, net_hw=hw, max_peaks=MAX_PEAKS,
                               net_bypass=True)
    peaks, scores = inf.fetch(*inf(net_out))
    extractor = PoseExtractor(model, max_peaks=MAX_PEAKS)
    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(batch):
            found, _ = extractor.assemble(peaks[i], scores[i],
                                          inf.scale_net_to_output)
            path = f"{tmp}/{i:012d}_keypoints.json"
            json_io.save_people_json(path, pose_keypoints=found)
            with open(path) as f:
                n_json = len(json.load(f)["people"])
            err = match_people(found, kp[i])
            check(n_json == people and err <= KEYPOINT_TOL_PX,
                  f"frame {i}: {found.shape[0]} people found (JSON "
                  f"{n_json}), {people} rendered; worst keypoint error "
                  f"{err:.2f} px")
            worst = max(worst, err)
    log(f"body injected: {batch} frames x {people} people recovered, worst "
        f"keypoint error {worst:.3f} px (bound {KEYPOINT_TOL_PX} px), "
        f"max peaks/part {int(peaks[:, :, 0, 0].max())}")


def phase_body_full(model, mesh, hw=NET_HW, batch=BATCH, seed=1):
    """Full program on raw frames; returns (frames, peaks, scores)."""
    from openpose_tpu.parallel.inference import ShardedPoseInference

    frames = np.random.RandomState(seed).randint(
        0, 256, (batch,) + tuple(hw) + (3,)).astype(np.uint8)
    inf = ShardedPoseInference(model, mesh, net_hw=hw, max_peaks=MAX_PEAKS)
    peaks, scores = inf.fetch(*inf(frames))
    counts = peaks[:, :, 0, 0]
    check(peaks.shape == (batch, model.info.num_parts, MAX_PEAKS + 1, 3),
          f"peaks shape {peaks.shape}")
    check(np.isfinite(scores).all(), "non-finite pair scores")
    log(f"body full: peaks {peaks.shape} scores {scores.shape}; peaks/part "
        f"min {int(counts.min())} max {int(counts.max())}")
    return frames, peaks, scores


def cnn_output(model, frames):
    """Standalone bf16 CNN forward of raw uint8 frames."""
    import jax
    import jax.numpy as jnp
    from openpose_tpu.models import graph
    from openpose_tpu.ops import resize

    fwd = jax.jit(lambda p, x: graph.forward(
        p, model.spec, resize.normalize_vgg(x.astype(jnp.float32)),
        jnp.bfloat16))
    return fwd(model.params, frames)


def paf_reference(model, src, peaks, hw=NET_HW):
    """Plain gather reference on net output `src`: materialized
    upsample_merge -> paf.paf_scores, at HIGHEST."""
    import jax
    import jax.numpy as jnp
    from openpose_tpu.ops import paf, resize

    pairs, map_idx = paf.pair_tables(model.info)

    @jax.jit
    def ref(src, peaks):
        merged = resize.upsample_merge([src], [1.0], hw)
        return paf.paf_scores(merged, peaks, jnp.asarray(pairs),
                              jnp.asarray(map_idx), 0.05, 0.95, 0.05)

    with jax.default_matmul_precision("highest"):
        return np.asarray(ref(src, peaks))


def compare_scores(label, got, want):
    """Fraction of pair-score entries within (PAF_RTOL, PAF_ATOL)."""
    close = np.isclose(got, want, rtol=PAF_RTOL, atol=PAF_ATOL)
    frac = float(close.mean())
    log(f"{label}: {frac:.6f} of {close.size} pair scores within rtol "
        f"{PAF_RTOL:g} atol {PAF_ATOL:g} (bound {PAF_MIN_FRACTION}); max "
        f"|diff| {float(np.abs(got - want).max()):.3e}")
    check(frac >= PAF_MIN_FRACTION, f"{label}: only {frac:.6f} close")


def phase_paf_vs_reference(model, mesh, frames, full_peaks, hw=NET_HW,
                           assemble_frames=2):
    """The program's post chain at the saturated 127-slot shapes against
    the plain gather reference.  Both sides read one standalone bf16 CNN
    output of the frames of (b), injected into the program as net output:
    a separately compiled forward differs from the one fused into the full
    program in the last bits of bf16, which alone moved ~1% of the scores
    past the tolerance on the card."""
    from openpose_tpu.parallel.inference import ShardedPoseInference
    from openpose_tpu.pose.extractor import PoseExtractor

    src = cnn_output(model, frames)
    inf = ShardedPoseInference(model, mesh, net_hw=hw, max_peaks=MAX_PEAKS,
                               net_bypass=True)
    peaks, scores = inf.fetch(*inf(src))
    same = float((peaks[:, :, 0, 0] == full_peaks[:, :, 0, 0]).mean())
    log(f"paf: peak counts equal to the full program's for {same:.4f} of "
        f"(frame, part); max peaks/part {int(peaks[:, :, 0, 0].max())}")
    k = scores.shape[-1]        # fetch() trims to the batch's peak bucket
    want = paf_reference(model, src, peaks, hw)[..., :k, :k]
    compare_scores("paf vs gather reference", scores, want)
    extractor = PoseExtractor(model, max_peaks=MAX_PEAKS)
    for i in range(min(assemble_frames, frames.shape[0])):
        kp_got, _ = extractor.assemble(peaks[i], scores[i], 1.0)
        kp_want, _ = extractor.assemble(peaks[i], want[i], 1.0)
        check(kp_got.shape == kp_want.shape
              and np.array_equal(kp_got, kp_want),
              f"frame {i}: assembled people differ ({kp_got.shape[0]} vs "
              f"{kp_want.shape[0]} reference)")
        log(f"paf frame {i}: {kp_got.shape[0]} people assembled, identical "
            f"to the reference")


# ---------------------------------------------------------------- whole body
def phase_wrapper(frame_hw=(720, 1280), seed=2):
    from openpose_tpu.params import FACE_NUMBER_PARTS, HAND_NUMBER_PARTS
    from openpose_tpu.wrapper import (FaceConfig, HandConfig, PoseConfig,
                                      Wrapper)

    frame = np.random.RandomState(seed).randint(
        0, 256, tuple(frame_hw) + (3,)).astype(np.uint8)
    wrapper = Wrapper(pose=PoseConfig(), face=FaceConfig(enable=True),
                      hand=HandConfig(enable=True))
    datum = wrapper.process(frame)
    n = datum.pose_keypoints.shape[0]
    check(datum.pose_keypoints.shape[1:] == (25, 3), "pose keypoints shape")
    check(n > 0, "random weights assembled nobody; nothing was cropped")
    check(datum.face_keypoints.shape == (n, FACE_NUMBER_PARTS, 3),
          f"face keypoints {datum.face_keypoints.shape}")
    check(datum.hand_left_keypoints.shape == (n, HAND_NUMBER_PARTS, 3)
          and datum.hand_right_keypoints.shape == (n, HAND_NUMBER_PARTS, 3),
          "hand keypoints shape")
    log(f"wrapper {frame_hw[1]}x{frame_hw[0]}: {n} people, face "
        f"{datum.face_keypoints.shape}, hands "
        f"{datum.hand_left_keypoints.shape}")


def phase_whole_body(model, mesh, hw=NET_HW, batch=BATCH, people=4,
                     td_net_size=368, seed=3):
    from openpose_tpu.models import zoo
    from openpose_tpu.params import FACE_NUMBER_PARTS, HAND_NUMBER_PARTS
    from openpose_tpu.runtime.whole_body import ShardedWholeBody

    _, net_out = render_people(model, hw, batch, people, seed)
    frames = np.random.RandomState(seed).randint(
        0, 256, (batch,) + tuple(hw) + (3,)).astype(np.uint8)
    wb = ShardedWholeBody(model, zoo.load_face_model(), zoo.load_hand_model(),
                          mesh=mesh, frame_hw=None, net_hw=hw,
                          face_net_size=td_net_size,
                          hand_net_size=td_net_size, net_bypass=True)
    results = wb(frames, net_output=net_out)
    check(len(results) == batch, "one result per frame")
    faces = hands = 0
    for i, r in enumerate(results):
        n = r.pose_keypoints.shape[0]
        check(n == people, f"frame {i}: {n} people, {people} rendered")
        check(r.face_keypoints.shape == (n, FACE_NUMBER_PARTS, 3),
              f"frame {i}: face {r.face_keypoints.shape}")
        check(r.hand_left_keypoints.shape == (n, HAND_NUMBER_PARTS, 3)
              and r.hand_right_keypoints.shape == (n, HAND_NUMBER_PARTS, 3),
              f"frame {i}: hands")
        faces += int((r.face_keypoints[..., 2] > 0).any(axis=-1).sum())
        hands += int((r.hand_left_keypoints[..., 2] > 0).any(axis=-1).sum()
                     + (r.hand_right_keypoints[..., 2] > 0).any(axis=-1).sum())
    check(faces == batch * people and hands == 2 * batch * people,
          f"crops with keypoints: {faces} faces, {hands} hands for "
          f"{batch * people} people")
    log(f"whole body: {batch} frames x {people} people, {faces} faces and "
        f"{hands} hands cropped at net size {td_net_size}")


# ---------------------------------------------------------------- train
def train_batch(model, hw, batch, seed):
    import jax.numpy as jnp
    from openpose_tpu.ops import resize

    kp, targets = render_people(model, hw, batch, 3, seed)
    del kp
    images = np.random.RandomState(seed).randint(
        0, 256, (batch,) + tuple(hw) + (3,)).astype(np.float32)
    return np.asarray(resize.normalize_vgg(jnp.asarray(images))), targets


def phase_train(model, device, hw=TRAIN_HW, batch=BATCH, steps=5, seed=4):
    import jax
    import optax
    from openpose_tpu import train

    optimizer = optax.adam(1e-4)
    state = jax.device_put(
        train.init_train_state(model.spec, optimizer, jax.random.PRNGKey(0)),
        device)
    images, targets = train_batch(model, hw, batch, seed)
    images, targets = jax.device_put((images, targets), device)
    step = jax.jit(train.make_train_step(model.spec, optimizer))
    loss_fn = jax.jit(lambda p, x, t: train.loss_fn(p, model.spec, x, t))
    before = float(loss_fn(state.params, images, targets))
    losses = []
    for _ in range(steps):
        state, loss = step(state, images, targets)
        losses.append(float(loss))
    after = float(loss_fn(state.params, images, targets))
    log(f"train {hw[0]}x{hw[1]} batch {batch}: loss {before:.6f} -> "
        f"{after:.6f} after {steps} steps (per step: "
        f"{', '.join(f'{v:.6f}' for v in losses)})")
    check(np.isfinite(losses + [before, after]).all(), "non-finite loss")
    check(after < before, "loss did not decrease")


# ---------------------------------------------------------------- 4 cards
def phase_multi_inference(model, devices, hw=NET_HW, per_card=BATCH,
                          seed=5):
    import jax
    from openpose_tpu.parallel import mesh as mesh_lib
    from openpose_tpu.parallel.inference import ShardedPoseInference

    n = len(devices)
    frames = np.random.RandomState(seed).randint(
        0, 256, (n * per_card,) + tuple(hw) + (3,)).astype(np.uint8)
    multi = ShardedPoseInference(model, mesh_lib.make_mesh(devices),
                                 net_hw=hw, max_peaks=MAX_PEAKS)
    peaks_dev, scores_dev = multi(frames)
    shard_devices = {s.device for s in peaks_dev.addressable_shards}
    check(len(shard_devices) == n and all(
        s.data.shape[0] == per_card for s in peaks_dev.addressable_shards),
        f"outputs not sharded over {n} cards: {peaks_dev.sharding}")
    peaks, scores = np.asarray(peaks_dev), np.asarray(scores_dev)
    # the one-card program at the same per-card batch, chunk by chunk
    single = ShardedPoseInference(model, mesh_lib.make_mesh(devices[:1]),
                                  net_hw=hw, max_peaks=MAX_PEAKS)
    want_peaks, want_scores = [], []
    for i in range(n):
        p, s = single(frames[i * per_card:(i + 1) * per_card])
        want_peaks.append(np.asarray(p))
        want_scores.append(np.asarray(s))
    want_peaks = np.concatenate(want_peaks)
    want_scores = np.concatenate(want_scores)
    same = float((peaks == want_peaks).all(-1).mean())
    log(f"{n}-card vs 1-card: {same:.6f} of peak slots identical")
    check(same == 1.0, "peaks differ from the one-card program")
    compare_scores(f"{n}-card vs 1-card scores", scores, want_scores)
    log(f"multi-card inference: {n * per_card} frames over {n} cards "
        f"({sorted(d.id for d in shard_devices)}), peaks identical to the "
        f"one-card program")


def phase_multi_train(model, devices, hw=TRAIN_HW, batch=BATCH, seed=6):
    """One (data=2, model=2) step vs the one-card step.  SGD with a unit
    step makes the parameter update the negated gradient itself."""
    import jax
    import optax
    from openpose_tpu import train
    from openpose_tpu.parallel import mesh as mesh_lib

    optimizer = optax.sgd(1.0)
    state0 = train.init_train_state(model.spec, optimizer,
                                    jax.random.PRNGKey(0))
    images, targets = train_batch(model, hw, batch, seed)
    step_fn = train.make_train_step(model.spec, optimizer)

    def run(mesh):
        p_shard = mesh_lib.param_sharding(mesh, state0.params)
        rep = mesh_lib.replicated(mesh)
        state = train.TrainState(
            jax.device_put(state0.params, p_shard),
            jax.device_put(state0.opt_state, rep),
            jax.device_put(state0.step, rep))
        batch_sh = mesh_lib.batch_sharding(mesh)
        with jax.default_matmul_precision("highest"):
            new, loss = jax.jit(step_fn)(
                state, jax.device_put(images, batch_sh),
                jax.device_put(targets, batch_sh))
            jax.block_until_ready(new.params)
        return new.params, float(loss)

    mesh = mesh_lib.make_mesh(devices, data=2, model=2)
    params4, loss4 = run(mesh)
    w = params4[model.spec.layers[0].name]["w"]
    check(len(w.sharding.device_set) == len(devices),
          f"params not spread over {len(devices)} cards")
    params1, loss1 = run(mesh_lib.make_mesh(devices[:1]))
    dloss = abs(loss4 - loss1) / abs(loss1)
    upd4 = [np.asarray(a) - np.asarray(b) for a, b in zip(
        jax.tree.leaves(params4), jax.tree.leaves(state0.params))]
    upd1 = [np.asarray(a) - np.asarray(b) for a, b in zip(
        jax.tree.leaves(params1), jax.tree.leaves(state0.params))]
    dupd = rel_l2(np.concatenate([u.ravel() for u in upd4]),
                  np.concatenate([u.ravel() for u in upd1]))
    log(f"multi-card train (data=2, model=2) vs 1 card, f32 HIGHEST: loss "
        f"{loss4:.8f} vs {loss1:.8f} (rel {dloss:.2e}, bound "
        f"{TRAIN_LOSS_RTOL:g}); parameter update rel L2 {dupd:.2e} (bound "
        f"{TRAIN_UPDATE_RTOL:g})")
    check(dloss <= TRAIN_LOSS_RTOL, "loss differs")
    check(dupd <= TRAIN_UPDATE_RTOL, "parameter updates differ")


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4),
                        help="4: run only the multi-card path")
    args = parser.parse_args(argv)

    devices = gpu_devices(args.cards)
    from openpose_tpu.models import zoo
    from openpose_tpu.parallel import mesh as mesh_lib
    from openpose_tpu.params import PoseModel

    phases = Phases()
    phases.run("device", phase_device, devices)
    model = zoo.load_pose_model(PoseModel.BODY_25, seed=0)
    if args.cards == 1:
        mesh = mesh_lib.make_mesh(devices)
        phases.run("cnn", phase_cnn, model, devices[0])
        phases.run("body_injected", phase_body_injected, model, mesh)
        frames, peaks, _ = phases.run("body_full", phase_body_full,
                                      model, mesh)
        phases.run("paf_vs_reference", phase_paf_vs_reference, model,
                   mesh, frames, peaks)
        phases.run("wrapper", phase_wrapper)
        phases.run("whole_body", phase_whole_body, model, mesh)
        phases.run("train", phase_train, model, devices[0])
    else:
        phases.run("multi_inference", phase_multi_inference, model, devices)
        phases.run("multi_train", phase_multi_train, model, devices)
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phases.times.items()}))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
