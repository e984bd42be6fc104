#!/usr/bin/env python3
"""Device-only train-step timing (chained).

The train loop's steady-state img/s bundles the per-step host->device
upload with compute; this probe chains N
data-dependent train steps inside one jit on device-resident data
(train_loop.device_step_probe), threading the TRAIN STATE through the
chain carry so the backward pass and optimizer update are live — the
round-4 version folded only the loss and XLA dead-code-eliminated the
entire backward, making it a forward-only measurement.

Run:  python scripts/profile_train_step.py [--image_size 368x656] [--batch 8]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image_size", default="368x656", help="HxW")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    from openpose_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    import jax
    from openpose_tpu.train_loop import TrainConfig, device_step_probe
    from openpose_tpu.params import PoseModel

    h, w = (int(v) for v in args.image_size.split("x"))
    config = TrainConfig(model=PoseModel.BODY_25, image_size=(h, w),
                         batch_size=args.batch)
    out = device_step_probe(config)
    out.update(image_size=f"{h}x{w}", batch=args.batch,
               device_kind=jax.devices()[0].device_kind)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
