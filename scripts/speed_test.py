#!/usr/bin/env python3
"""Per-stage device timing (scripts/tests/speed_test.sh equivalent)."""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from openpose_tpu.models import graph, zoo
    from openpose_tpu.ops import nms, paf, resize
    from openpose_tpu.params import PoseModel

    model = zoo.load_pose_model(PoseModel.BODY_25)
    pairs = jnp.asarray(paf.pair_tables(model.info)[0])
    map_idx = jnp.asarray(paf.pair_tables(model.info)[1])
    num_parts = model.info.num_parts
    net_h, net_w = 368, 656
    img = jnp.asarray(np.random.RandomState(0).uniform(
        0, 255, (1, net_h, net_w, 3)).astype(np.float32))

    def timed(name, fn, *args, n=10):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        print(f"{name}: {(time.perf_counter() - t0) / n * 1000:.2f} ms")
        return out

    f_net = jax.jit(lambda p, x: graph.forward(
        p, model.spec, resize.normalize_vgg(x), jnp.bfloat16))
    out = timed("net forward (bf16)", f_net, model.params, img)
    f_res = jax.jit(lambda o: resize.resize_bicubic(o, (net_h, net_w)))
    merged = timed("resize 8x (all channels)", f_res, out)
    f_nms = jax.jit(lambda m: nms.nms(m[..., :num_parts], 0.05, 127))
    peaks = timed("nms", f_nms, merged)
    f_paf = jax.jit(lambda m, pk: paf.paf_scores(
        m, pk, pairs, map_idx, 0.05, 0.95, 0.05))
    timed("paf scores", f_paf, merged, peaks)


if __name__ == "__main__":
    main()
