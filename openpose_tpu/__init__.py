"""openpose_tpu: multi-person pose estimation in JAX (OpenPose capabilities)."""

__version__ = "0.1.0"
