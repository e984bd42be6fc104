"""Multi-process "fake cluster" test: jax.distributed over 2 CPU processes.

The reference has no distributed runtime (SURVEY §5.8); this framework
scales over hosts, so we validate the multi-host path the way SURVEY §4
prescribes: two local processes, each with 4 virtual CPU devices, running
the SAME sharded training step over the global 8-device mesh.
"""

import os
import pathlib
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:%PORT%",
                           num_processes=2, process_id=proc_id)
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from openpose_tpu import train
from openpose_tpu.models import graph
from openpose_tpu.ops import paf as paf_ops
from openpose_tpu.ops.resize import normalize_vgg
from openpose_tpu.parallel import mesh as mesh_lib
from openpose_tpu.params import POSE_MODEL_INFO, PoseModel

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

info = POSE_MODEL_INFO[PoseModel.MPI_15_4]
spec = graph.load_spec(info.spec)
optimizer = optax.adam(1e-4)
state = train.init_train_state(spec, optimizer, jax.random.PRNGKey(0))
mesh = mesh_lib.make_mesh(model=2)   # 4 x 2 over 8 global devices
state = train.TrainState(
    jax.device_put(state.params, mesh_lib.param_sharding(mesh, state.params)),
    jax.device_put(state.opt_state, jax.tree.map(
        lambda _: mesh_lib.replicated(mesh), state.opt_state,
        is_leaf=lambda x: hasattr(x, "shape"))),
    jax.device_put(state.step, mesh_lib.replicated(mesh)))

pairs = jnp.asarray(paf_ops.pair_tables(info)[0])
map_idx = jnp.asarray(paf_ops.pair_tables(info)[1])
kp = np.zeros((4, 1, info.num_parts, 3), np.float32)
kp[..., 0] = 16.0; kp[..., 1] = 16.0; kp[..., 2] = 1.0

def full_step(state, images, keypoints):
    targets = train.make_targets(keypoints, pairs, map_idx, (32, 32),
                                 info.num_parts, info.heatmap_channels)
    base = train.make_train_step(spec, optimizer, jnp.float32)
    return base(state, normalize_vgg(images), targets)

batch_sh = mesh_lib.batch_sharding(mesh)
step_fn = jax.jit(full_step, in_shardings=(None, batch_sh, batch_sh))
# Global batch 4 = 1 per data-mesh slot; make_array from per-host shards
global_imgs = jnp.zeros((4, 32, 32, 3), jnp.float32)
with mesh:
    imgs = jax.device_put(global_imgs, batch_sh)
    kps = jax.device_put(jnp.asarray(kp), batch_sh)
    state, loss = step_fn(state, imgs, kps)
    loss.block_until_ready()
print(f"proc {proc_id} OK loss={float(loss):.6f}", flush=True)
"""


_INFER_WORKER = r"""
import os, sys, time
proc_id = int(sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:%PORT%",
                           num_processes=2, process_id=proc_id)
import numpy as np
import jax.numpy as jnp
from openpose_tpu.models import zoo
from openpose_tpu.params import PoseModel
from openpose_tpu.parallel import mesh as mesh_lib
from openpose_tpu.parallel.inference import ShardedPoseInference

assert jax.process_count() == 2 and len(jax.devices()) == 8
model = zoo.load_pose_model(PoseModel.MPI_15_4)
mesh = mesh_lib.make_mesh(model=1)       # pure data parallel over 8 devices
inf = ShardedPoseInference(model, mesh, net_hw=(64, 64), max_peaks=16,
                           compute_dtype=jnp.float32)
# global batch 8 = 4 per host; each host feeds only its local shard
local = np.random.RandomState(proc_id).randint(
    0, 255, (4, 64, 64, 3)).astype(np.uint8)
out = inf(local)
jax.block_until_ready(out)               # compile
iters = 6
t0 = time.perf_counter()
for _ in range(iters):
    out = inf(local)
    jax.block_until_ready(out)
dt = time.perf_counter() - t0
print(f"proc {proc_id} OK frames_per_s={8 * iters / dt:.2f}", flush=True)
"""


def _run_workers(tmp_path, source, timeout=900, parse=None):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(source.replace("%PORT%", str(port)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
    return outs


@pytest.mark.slow
def test_two_process_training_step(tmp_path):
    _run_workers(tmp_path, _WORKER)


@pytest.mark.slow
def test_two_host_scaling_efficiency(tmp_path):
    """MEASURED weak-scaling efficiency 1 -> 2 emulated hosts (each a
    pinned core + one XLA device, real jax.distributed coordination) must
    hit the >=80% north-star target (BASELINE.md).  The program is
    collective-free, so the efficiency loss is pure runtime overhead."""
    import importlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "scripts"))
    scaling_bench = importlib.import_module("scaling_bench")
    report = scaling_bench.measure(batch=8, iters=8, reps=3,
                                   workdir=tmp_path, four_host=False)
    assert report["collectives_inference"] == {}
    assert report["efficiency_2_hosts_median"] >= 0.8, report


@pytest.mark.slow
def test_two_process_sharded_inference_throughput(tmp_path):
    """2-host data-parallel inference: both processes execute the global
    program and report a global frames/s; the two measurements must agree
    (same program, same barrier) — the CPU-mesh proxy for the >=80%
    2-host scaling target (BASELINE.md)."""
    outs = _run_workers(tmp_path, _INFER_WORKER)
    rates = []
    for out in outs:
        for line in out.splitlines():
            if "frames_per_s=" in line:
                rates.append(float(line.split("frames_per_s=")[1]))
    assert len(rates) == 2, outs
    assert min(rates) > 0
    # both processes time the same global computation: within 2x of each
    # other (generous: CI CPU noise), i.e. no straggler/desync
    assert max(rates) / min(rates) < 2.0, rates
