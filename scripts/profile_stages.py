#!/usr/bin/env python3
"""Per-stage timing of the device pipeline on the GPU."""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import time
import numpy as np
import jax
import jax.numpy as jnp
from openpose_tpu.models import graph, zoo
from openpose_tpu.ops import nms, paf, resize
from openpose_tpu.params import PoseModel


def timeit(name, fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1000
    print(f"{name:34s} {dt:8.2f} ms")
    return out


def main():
    model = zoo.load_pose_model(PoseModel.BODY_25)
    pairs, map_idx = (jnp.asarray(t) for t in paf.pair_tables(model.info))
    num_parts = model.info.num_parts
    net_h, net_w = 368, 656
    import os
    batches = tuple(int(b) for b in
                    os.environ.get("PROFILE_BATCHES", "1,8").split(","))
    for batch in batches:
        print(f"--- batch={batch} ---")
        rng = np.random.RandomState(0)
        images = jnp.asarray(
            rng.uniform(0, 255, (batch, net_h, net_w, 3)).astype(np.float32))

        fwd = jax.jit(lambda p, x: graph.forward(
            p, model.spec, resize.normalize_vgg(x), jnp.bfloat16))
        out = timeit("forward (bf16)", fwd, model.params, images)

        rsz = jax.jit(lambda o: resize.resize_bicubic(o, (net_h, net_w)))
        merged = timeit("resize_bicubic x8 (all channels)", rsz, out)

        nmsf = jax.jit(lambda m: nms.nms(m[..., :num_parts], 0.05, 127))
        peaks = timeit("nms", nmsf, merged)
        counts = np.asarray(peaks)[:, :, 0, 0]
        print(f"  peak counts: max={counts.max():.0f} mean={counts.mean():.1f}")

        paff = jax.jit(lambda m, pk: paf.paf_scores(
            m, pk, pairs, map_idx, 0.05, 0.95, 0.05))
        timeit("paf scores", paff, merged, peaks)

        full = jax.jit(lambda p, x: _full(p, x))

        def _full(p, x):
            o = graph.forward(p, model.spec, resize.normalize_vgg(x),
                              jnp.bfloat16)
            m = resize.resize_bicubic(o, (net_h, net_w))
            pk = nms.nms(m[..., :num_parts], 0.05, 127)
            sc = paf.paf_scores(m, pk, pairs, map_idx, 0.05, 0.95, 0.05)
            return pk, sc
        timeit("FULL pipeline", full, model.params, images)


if __name__ == "__main__":
    main()
