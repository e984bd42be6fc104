"""Model zoo, caffemodel conversion, checkpointing, sharded inference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from openpose_tpu.models import caffe_proto, checkpoint, graph, zoo
from openpose_tpu.params import PoseModel, POSE_MODEL_INFO


class TestSpecs:
    @pytest.mark.parametrize("model",
                             [m for m in PoseModel if not m.experimental])
    def test_pose_output_channels(self, model):
        info = POSE_MODEL_INFO[model]
        spec = graph.load_spec(info.spec)
        # walk channels through the graph like init_params does
        params = graph.init_params(spec, jax.random.PRNGKey(0))
        x = jnp.zeros((1, 32, 32, 3))
        out = graph.forward(params, spec, x, jnp.float32)
        assert out.shape == (1, 4, 4, info.heatmap_channels)

    def test_face_hand_channels(self):
        for name, ch in (("face_70", 71), ("hand_21", 22)):
            spec = graph.load_spec(name)
            params = graph.init_params(spec, jax.random.PRNGKey(0))
            out = graph.forward(params, spec, jnp.zeros((1, 32, 32, 3)),
                                jnp.float32)
            assert out.shape[-1] == ch


class TestCaffemodelConversion:
    def test_roundtrip_synthetic(self, tmp_path):
        """Serialize a fake caffemodel for a tiny spec, parse, convert, run."""
        spec = caffe_proto.NetSpec(
            name="tiny", input="image", input_channels=3, output="out",
            layers=[
                caffe_proto.LayerSpec("conv1", "Convolution", ["image"],
                                      ["conv1"], num_output=4, kernel=3,
                                      pad=1),
                caffe_proto.LayerSpec("prelu1", "PReLU", ["conv1"], ["conv1"]),
                caffe_proto.LayerSpec("conv2", "Convolution", ["conv1"],
                                      ["out"], num_output=2, kernel=1),
            ])
        rng = np.random.RandomState(0)
        w1 = rng.randn(4, 3, 3, 3).astype(np.float32)   # OIHW
        b1 = rng.randn(4).astype(np.float32)
        s1 = rng.randn(4).astype(np.float32)
        w2 = rng.randn(2, 4, 1, 1).astype(np.float32)
        b2 = rng.randn(2).astype(np.float32)
        blob_bytes = caffe_proto.serialize_caffemodel(
            {"conv1": [w1, b1], "prelu1": [s1], "conv2": [w2, b2]})
        parsed = caffe_proto.parse_caffemodel(blob_bytes)
        np.testing.assert_allclose(parsed["conv1"][0], w1)
        np.testing.assert_allclose(parsed["prelu1"][0], s1)

        params = graph.convert_caffe_blobs(spec, parsed)
        assert params["conv1"]["w"].shape == (3, 3, 3, 4)  # HWIO
        # Forward equals direct conv math on a probe
        x = rng.randn(1, 5, 5, 3).astype(np.float32)
        out = np.asarray(graph.forward(params, spec, jnp.asarray(x),
                                       jnp.float32))
        # center pixel of conv1 via manual OIHW conv
        manual = np.zeros(4)
        for o in range(4):
            manual[o] = np.sum(w1[o].transpose(1, 2, 0) * x[0, 1:4, 1:4, :]) \
                + b1[o]
        manual = np.where(manual >= 0, manual, manual * s1)
        want = w2[:, :, 0, 0] @ manual + b2
        np.testing.assert_allclose(out[0, 2, 2], want, rtol=1e-4, atol=1e-4)

    def test_checkpoint_roundtrip(self, tmp_path):
        model = zoo.load_pose_model(PoseModel.MPI_15_4)
        path = str(tmp_path / "weights.npz")
        checkpoint.save(path, model.params)
        loaded = checkpoint.load(path)
        for layer in model.params:
            for key in model.params[layer]:
                np.testing.assert_allclose(
                    np.asarray(loaded[layer][key]),
                    np.asarray(model.params[layer][key]))


class TestShardedInference:
    def test_data_parallel_batch(self):
        from openpose_tpu.parallel.inference import ShardedPoseInference
        from openpose_tpu.parallel import mesh as mesh_lib
        devices = jax.devices()
        if len(devices) < 2:
            pytest.skip("needs multiple devices")
        mesh = mesh_lib.make_mesh(devices[:4], model=1)
        model = zoo.load_pose_model(PoseModel.MPI_15_4)
        inf = ShardedPoseInference(model, mesh, net_hw=(64, 64),
                                   max_peaks=16, compute_dtype=jnp.float32)
        images = jnp.asarray(
            np.random.RandomState(0).uniform(0, 255, (4, 64, 64, 3))
            .astype(np.float32))
        peaks, scores = inf(images)
        assert peaks.shape == (4, 15, 17, 3)
        assert scores.shape[0] == 4
        # Per-sample results identical to unsharded single-device run
        single = ShardedPoseInference(
            model, mesh_lib.make_mesh(devices[:1], model=1),
            net_hw=(64, 64), max_peaks=16, compute_dtype=jnp.float32)
        peaks1, scores1 = single(images)
        np.testing.assert_allclose(np.asarray(peaks), np.asarray(peaks1),
                                   atol=1e-4)

    @pytest.mark.parametrize("max_count,k", [(3, 8), (20, 32), (100, 127)])
    def test_fetch_trims_scores_to_bucket(self, max_count, k):
        """fetch() returns the pair scores cut to the smallest bucket that
        covers the batch's largest per-part peak count (the full matrix
        above the largest bucket), and the peaks unchanged."""
        from openpose_tpu.parallel.inference import ShardedPoseInference
        from openpose_tpu.parallel import mesh as mesh_lib
        model = zoo.load_pose_model(PoseModel.MPI_15_4)
        inf = ShardedPoseInference(
            model, mesh_lib.make_mesh(jax.devices()[:1]), net_hw=(64, 64),
            max_peaks=127)
        rng = np.random.RandomState(0)
        peaks = np.zeros((2, 15, 128, 3), np.float32)
        peaks[:, :, 0, 0] = rng.randint(0, max_count + 1, (2, 15))
        peaks[1, 4, 0, 0] = max_count
        scores = rng.uniform(-1, 1, (2, 14, 127, 127)).astype(np.float32)
        got_peaks, got_scores = inf.fetch(jnp.asarray(peaks),
                                          jnp.asarray(scores))
        np.testing.assert_array_equal(got_peaks, peaks)
        np.testing.assert_array_equal(got_scores, scores[:, :, :k, :k])

    def test_data_parallel_is_collective_free(self):
        """Scaling guarantee: the data-parallel inference program contains
        zero cross-device collectives (throughput scales linearly with
        chips; scripts/analyze_scaling.py prints the full report)."""
        import re
        from openpose_tpu.parallel.inference import ShardedPoseInference
        from openpose_tpu.parallel import mesh as mesh_lib
        devices = jax.devices()
        if len(devices) < 2:
            pytest.skip("needs multiple devices")
        mesh = mesh_lib.make_mesh(devices[:4], model=1)
        model = zoo.load_pose_model(PoseModel.MPI_15_4)
        inf = ShardedPoseInference(model, mesh, net_hw=(64, 64),
                                   max_peaks=16, compute_dtype=jnp.float32)
        images = jax.device_put(jnp.zeros((4, 64, 64, 3), jnp.float32),
                                mesh_lib.batch_sharding(mesh))
        hlo = inf._fn.lower(inf.params, images).compile().as_text()
        for op in ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all"):
            assert not re.search(rf"= \S+ {op}", hlo), f"found {op}"


class TestExperimentalModels:
    def test_enum_surface_matches_reference(self):
        # all 15 reference PoseModel values exist (enumClasses.hpp:9-30)
        names = {m.name for m in PoseModel}
        for want in ("BODY_25", "COCO_18", "MPI_15", "MPI_15_4", "BODY_19",
                     "BODY_19_X2", "BODY_19N", "BODY_19E", "BODY_25B",
                     "BODY_25D", "BODY_25E", "BODY_23", "BODY_135",
                     "CAR_12", "CAR_22"):
            assert want in names

    def test_experimental_raises_with_guidance(self):
        import pytest
        with pytest.raises(ValueError, match="prototxt"):
            zoo.load_pose_model(PoseModel.BODY_135)

    def test_cli_experimental_model_errors_cleanly(self):
        import pytest
        from openpose_tpu import cli
        with pytest.raises((SystemExit, ValueError)):
            cli.main(["--image_dir", "/nonexistent",
                      "--model_pose", "CAR_12"])
