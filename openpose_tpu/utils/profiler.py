"""Keyed timers + averaged reports (reference Profiler,
include/openpose/utilities/profiler.hpp:66-100, src 319 LoC).

Device timing caveat: JAX dispatch is asynchronous — `timer_end` blocks on
the given arrays (block_until_ready) when passed, mirroring the reference's
cudaDeviceSynchronize-bracketed OP_CUDA_PROFILE macros (profiler.hpp:31-65).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import jax


class Profiler:
    enabled: bool = True

    def __init__(self, report_every: int = 1000):
        self.report_every = report_every
        self._acc: Dict[str, float] = collections.defaultdict(float)
        self._count: Dict[str, int] = collections.defaultdict(int)
        self._open: Dict[str, float] = {}

    def timer_init(self, key: str) -> None:
        if self.enabled:
            self._open[key] = time.perf_counter()

    def timer_end(self, key: str, device_arrays=None) -> float:
        if not self.enabled or key not in self._open:
            return 0.0
        if device_arrays is not None:
            jax.block_until_ready(device_arrays)
        dt = time.perf_counter() - self._open.pop(key)
        self._acc[key] += dt
        self._count[key] += 1
        if self._count[key] % self.report_every == 0:
            print(self.report_line(key))
        return dt

    def report_line(self, key: str) -> str:
        avg = self._acc[key] / max(self._count[key], 1) * 1000.0
        return f"[profiler] {key}: {avg:.2f} ms avg over {self._count[key]}"

    def report(self) -> str:
        return "\n".join(self.report_line(k) for k in sorted(self._acc))

    def averages_ms(self) -> Dict[str, float]:
        return {k: self._acc[k] / max(self._count[k], 1) * 1000.0
                for k in self._acc}


GLOBAL_PROFILER = Profiler()
