"""Test config: force the CPU backend with 8 virtual devices so sharding tests
run anywhere, GPU machines included (set here, before any backend is
initialized).  What only the GPU can run is a phase of chip_smoke.py."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
