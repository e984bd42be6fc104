"""Chained-iteration device timing and the device peak table.

``chain_ms`` runs N data-dependent iterations of the workload inside ONE
jitted ``lax.fori_loop`` whose carry scalar perturbs the inputs and folds the
outputs (so iterations serialize and nothing is constant-folded or
deduplicated), reads back a single scalar, and reports
``(t(n_hi) - t(n_lo)) / (n_hi - n_lo)`` — per-call dispatch, the host
readback and any other fixed cost cancel in the difference.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

# Published dense peaks per device, keyed by jax ``device_kind``: TFLOP/s by
# operand precision and HBM bandwidth in TB/s.  Source: NVIDIA H100 Tensor
# Core GPU data sheet, SXM part, dense rates without sparsity, at the 700 W
# power limit (a card capped lower cannot hold these clocks under load, so
# report the card's power limit beside any share of them).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0,
                              "hbm_tbps": 3.35},
}


def device_peak(key: str = "bf16", device_kind: str | None = None) -> float:
    """Published peak of ``device_kind`` (default: the first device) for
    ``key`` in PEAKS: "bf16" / "tf32" / "fp32" TFLOP/s or "hbm_tbps".

    An unknown device raises: a silent 0.0 would turn every utilization
    into 0 and switch off the roofline guard."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; known: {sorted(PEAKS)}")
    return PEAKS[device_kind][key]


def fold(carry: jax.Array, *outputs: jax.Array) -> jax.Array:
    """Fold a FULL reduction of every output into the chain carry.

    A single consumed output element is NOT enough to keep a chained stage
    alive: XLA can slice-propagate the one element backwards and
    dead-code-eliminate most of the stage (this once produced a 4-scale
    number implying more than the chip's peak).  ``jnp.sum`` over each output
    costs microseconds at these sizes and closes that hole for good: every
    element of every output feeds the carry, so nothing upstream is dead.
    """
    for out in outputs:
        carry = carry + jnp.sum(out, dtype=jnp.float32) * 1e-12
    return carry


def chain_ms(step_fn: Callable[[jax.Array], jax.Array],
             n_lo: int = 2, n_hi: int = 22, reps: int = 3) -> float:
    """Milliseconds per application of step_fn (carry f32 scalar -> carry).

    step_fn must thread its scalar argument into the workload inputs (e.g.
    ``inputs + carry * 1e-12``) and fold a FULL reduction of every output
    back into the returned carry (use ``fold``) — a single consumed element
    lets XLA slice-propagate and drop most of the body (see ``fold``).
    """
    @jax.jit
    def run(n):
        return jax.lax.fori_loop(
            0, n, lambda i, c: step_fn(c), jnp.float32(0.0))

    float(run(jnp.int32(n_hi)))           # compile + warm the whole chain

    def timed(n):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(run(jnp.int32(n)))      # scalar readback = true sync
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo = timed(n_lo)
    t_hi = timed(n_hi)
    return max(t_hi - t_lo, 0.0) / (n_hi - n_lo) * 1000.0
