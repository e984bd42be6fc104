#!/usr/bin/env python
"""Per-stage CNN timing + speed-of-light accounting (BODY_25 368x656).

Times cumulative prefixes of the layer graph at architectural cut points
with the chained-iteration method (utils/benchmark.chain_ms), differences
them into per-stage ms, and reports each stage's achieved TFLOP/s vs the
device's bf16 peak (utils/benchmark.PEAKS).  Answers "which layers keep
the CNN off speed-of-light" — the stride-1 VGG head at full input
resolution is the usual suspect (low arithmetic intensity).

Each distinct prefix is one fresh XLA program: the first run compiles it,
later runs hit the persistent cache.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

CUTS = ["pool1_stage1", "pool2_stage1", "pool3_stage1", "conv4_2",
        "prelu4_2", "Mconv7_stage0_L2", "Mconv7_stage1_L2",
        "Mconv7_stage0_L1"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--net_resolution", default="656x368")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from openpose_tpu.models import graph, zoo
    from openpose_tpu.ops import resize
    from openpose_tpu.params import PoseModel
    from openpose_tpu.utils.benchmark import chain_ms, fold
    from openpose_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    w, h = (int(v) for v in args.net_resolution.split("x"))
    model = zoo.load_pose_model(PoseModel.BODY_25)
    spec = model.spec
    names = [l.name for l in spec.layers]
    cuts = [c for c in CUTS if c in names] + [spec.layers[-1].name]
    flops = graph.count_flops(spec, (h, w))

    rng = np.random.RandomState(0)
    images = jnp.asarray(rng.uniform(0, 255, (args.batch, h, w, 3))
                         .astype(np.float32))

    def prefix_step(upto):
        idx = names.index(upto) + 1
        import dataclasses
        sub = dataclasses.replace(
            spec, output=spec.layers[idx - 1].tops[0],
            layers=spec.layers[:idx])

        def step(c):
            out = graph.forward(model.params, sub,
                                resize.normalize_vgg(images + c * 1e-12),
                                jnp.bfloat16)
            return fold(c, out)
        return step

    kind = jax.devices()[0].device_kind
    from openpose_tpu.utils.benchmark import device_peak
    peak = device_peak("bf16", kind)
    print(f"# device {kind}, bf16 peak {peak} TFLOP/s, batch {args.batch}")
    prev_ms, prev_fl = 0.0, 0
    rows = []
    for cut in cuts:
        t0 = time.time()
        ms = chain_ms(prefix_step(cut))
        idx = names.index(cut) + 1
        fl = sum(flops[l.name] for l in spec.layers[:idx])
        d_ms = (ms - prev_ms) / args.batch
        d_fl = (fl - prev_fl) / 1e9
        tf = d_fl / d_ms if d_ms > 1e-6 else float("inf")
        rows.append((cut, d_ms, d_fl, tf))
        print(f"  ..{cut:<20} stage {d_ms:6.3f} ms/frame  {d_fl:6.1f} GFLOP "
              f"-> {tf:6.1f} TFLOP/s ({tf / peak:5.1%} of peak)  "
              f"[cumulative {ms / args.batch:.3f} ms; wall {time.time() - t0:.0f}s]",
              flush=True)
        prev_ms, prev_fl = ms, fl
    return 0


if __name__ == "__main__":
    sys.exit(main())
