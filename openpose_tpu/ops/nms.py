"""NMS peak extraction: 3x3 local maxima + 7x7 sub-pixel refinement.

Reference semantics (src/openpose/net/nmsBase.cpp:6-170, CUDA twin
nmsBase.cu):

* interior pixels (1 < x < W-2, 1 < y < H-2): peak iff value > threshold and
  strictly greater than all 8 neighbors;
* first inner border (x==1 | x==W-2 | y==1 | y==H-2): ``>=`` comparisons, with
  missing neighbors treated as `threshold` (this asymmetric rule absorbs the
  resize artifacts the reference documents at nmsBase.cpp:10-14);
* outermost border: never a peak;
* peaks are emitted in row-major scan order, capped at `max_peaks`;
* sub-pixel refinement (nmsAccuratePeakPosition, nmsBase.cpp:70-107): score-
  weighted centroid over the 7x7 window (only score>0 samples) plus a
  (+0.5, +0.5) "Matlab offset"; the reported score is the raw peak value.

Output layout matches the reference target blob: [N, C, max_peaks+1, 3] with
slot 0 carrying the peak count in component 0.

The implementation is pure XLA with no gathers on the hot path: shifted
compares for the 3x3 test, a sort-free searchsorted compaction with
one-hot selections, and band-matrix contractions for the 7x7
sub-pixel refinement — all static shapes, tier-laddered by the batch's
true max peak count.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _shifted_neighbors(x: jax.Array, fill: jax.Array):
    """The 8 one-pixel shifts of NHWC `x`, out-of-range lanes = `fill`.

    Pads ONCE with the fill value and takes 8 static slices of the shared
    padded buffer — XLA fuses the slices into the consuming compares, so
    the whole 3x3 neighborhood test is a single pass over the heatmap
    (8 separate pad+where copies cost ~8x the HBM traffic)."""
    padded = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)),
                     constant_values=fill)
    return [jax.lax.dynamic_slice(padded, (0, 1 + dy, 1 + dx, 0), x.shape)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)]


def _searchsorted_rows(cum: jax.Array, ranks: jax.Array) -> jax.Array:
    """Per-row searchsorted-left of `ranks` [K] into monotone `cum` [..., S]:
    first index where cum >= rank, computed as count of entries < rank —
    a pure compare-and-reduce (no sort, no loop), ideal on the VPU."""
    return jnp.sum(cum[..., None, :] < ranks[:, None], axis=-1)


def _refine_dense(heat: jax.Array, peak_idx: jax.Array,
                  offset: Tuple[float, float]
                  ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Full-budget refinement as BAND-MATRIX contractions.

    The 7-row window SUM of max(heat, 0) for all K peaks of one map is

        band[K, H] @ hpos[H, W]          band[k, y] = 1{|y - py_k| <= 3}

    and the y-weighted sum uses band*y — one einsum over the stacked
    [N, C, 2K+1(K), H] left factors per map (~51 GFLOP at batch 8).  The
    column window is then a masked reduce over the last dimension of the
    [N, C, K, W] products.
    Precision.HIGHEST keeps the contraction f32-exact (a reduced-precision
    pass would round the map values, visible against the scalar oracle);
    the band entries are exact 0/1 and ints < 2^24,
    so the sums match the masked-sum formulation to f32 rounding.  Out-of
    -bounds taps never enter (the band clips at the map edge), matching
    the reference's skipped samples (nmsBase.cpp:70-107).  Used for every
    tier.  Whether a gather-based refinement is faster on the GPU is not
    measured yet (ROADMAP S6).
    """
    n, h, w, c = heat.shape
    k = peak_idx.shape[2]
    # C-major [N,C,H,W]: W-minor pads 656 -> 768 lanes vs C-minor's
    # 26 -> 128 (~5x waste) for every pass below
    chw = heat.transpose(0, 3, 1, 2)
    hpos = jnp.maximum(chw, 0.0)
    py = peak_idx // w                                        # [N,C,K]
    px = peak_idx % w
    ih = jnp.arange(h, dtype=jnp.int32)
    f32 = jnp.float32
    bandy = (jnp.abs(ih - py[..., None]) <= 3).astype(f32)    # [N,C,K,H]
    lhs = jnp.concatenate([
        bandy,                                                # 7-row sums
        bandy * ih.astype(f32),                               # y-weighted
    ], axis=2)                                                # [N,C,2K,H]
    prod = jnp.einsum("nckh,nchw->nckw", lhs, hpos,
                      precision=jax.lax.Precision.HIGHEST)
    rows7, yrows7 = prod[:, :, :k], prod[:, :, k:]            # [N,C,K,W]
    vrow = jnp.einsum("nckh,nchw->nckw",
                      (ih == py[..., None]).astype(f32), chw,
                      precision=jax.lax.Precision.HIGHEST)
    iw = jnp.arange(w, dtype=jnp.int32)
    bandx = jnp.abs(iw - px[..., None]) <= 3                  # [N,C,K,W]
    xsw = iw.astype(f32)
    s_at = jnp.sum(jnp.where(bandx, rows7, 0.0), axis=-1)
    sx_at = jnp.sum(jnp.where(bandx, rows7 * xsw, 0.0), axis=-1)
    sy_at = jnp.sum(jnp.where(bandx, yrows7, 0.0), axis=-1)
    value = jnp.sum(jnp.where(iw == px[..., None], vrow, 0.0), axis=-1)
    denom = jnp.where(s_at > 0, s_at, 1.0)
    return (sx_at / denom + offset[0], sy_at / denom + offset[1], value)


@functools.partial(jax.jit, static_argnames=("max_peaks", "offset",
                                             "fast_peaks"))
def nms(heatmaps: jax.Array, threshold: jax.Array, max_peaks: int = 127,
        offset: Tuple[float, float] = (0.5, 0.5),
        fast_peaks: Tuple[int, ...] = (16, 48)) -> jax.Array:
    """Extract peaks from [N, H, W, C] part heatmaps.

    Returns [N, C, max_peaks+1, 3] float32; [n, c, 0, 0] is the count,
    slots 1..count are (x, y, score) in row-major discovery order.

    fast_peaks: tier ladder for the sub-pixel refinement.  Refinement cost
    scales with the SLOT budget, not the true peak count — at the static
    max_peaks=127 the band-matmul left factors and [N, C, K, W] products are ~8x the
    tier-16 size even when frames carry a handful of peaks.  Nested
    lax.cond picks the smallest tier covering this batch's true max count;
    slots beyond the tier are invalid by construction (count <= k), so
    refining only the leading k slots is exact.  Pass () to disable.
    """
    heat = heatmaps.astype(jnp.float32)
    n, h, w, c = heat.shape
    thr = jnp.asarray(threshold, jnp.float32)

    neigh = _shifted_neighbors(heat, thr)
    gt_all = jnp.ones_like(heat, bool)
    ge_all = jnp.ones_like(heat, bool)
    for nb in neigh:
        gt_all &= heat > nb
        ge_all &= heat >= nb

    ys = jnp.arange(h)[None, :, None, None]
    xs = jnp.arange(w)[None, None, :, None]
    interior = (xs > 1) & (xs < w - 2) & (ys > 1) & (ys < h - 2)
    inner = ((xs == 1) | (xs == w - 2) | (ys == 1) | (ys == h - 2))
    is_peak = (heat > thr) & ((interior & gt_all) | (inner & ge_all))

    # Compaction: first `max_peaks` peaks in row-major order per (n, c).
    # Sort-free exact selection (no top_k or sort).  Peaks already appear
    # in ascending flat-index order, so the k-th peak's position is searchsorted(cumsum(is_peak), k) — a monotone
    # binary-search-free compare-and-count, no sort anywhere:
    #   1. block stage: the first <= max_peaks peaks lie in the first
    #      <= max_peaks 128-pixel blocks containing any peak; pick those
    #      blocks by rank via searchsorted over the nonempty-block cumsum;
    #   2. within the <= max_peaks*128 gathered candidates, pick the k-th
    #      flagged entry the same way.
    flat_idx = (ys * w + xs).astype(jnp.int32)          # [1,H,W,1]
    big = jnp.int32(h * w)
    masked = jnp.where(is_peak, flat_idx, big)          # [N,H,W,C]
    masked = masked.transpose(0, 3, 1, 2).reshape(n, c, h * w)
    bs = 128
    nb = -(-h * w // bs)
    padded = jnp.pad(masked, ((0, 0), (0, 0), (0, nb * bs - h * w)),
                     constant_values=big)
    blocks = padded.reshape(n, c, nb, bs)
    block_first = blocks.min(axis=-1)                   # [N,C,NB]
    k_blocks = min(max_peaks, nb)
    ranks_b = jnp.arange(1, k_blocks + 1, dtype=jnp.int32)
    cum_blocks = jnp.cumsum((block_first < big).astype(jnp.int32), axis=-1)
    # first block index whose nonempty-rank reaches r, ascending by
    # construction; rows with fewer nonempty blocks than k_blocks clamp to
    # the LAST block, which (for small heatmaps, h*w <= k_blocks*bs) can
    # still hold valid peaks — so those duplicate selections must be masked
    # out or the duplicated entries would be counted again downstream.
    blk_id = jnp.minimum(_searchsorted_rows(cum_blocks, ranks_b), nb - 1)
    rank_ok = ranks_b <= cum_blocks[..., -1:]           # [N,C,K]
    cand = jnp.take_along_axis(blocks, blk_id[..., None], axis=2)
    cand = jnp.where(rank_ok[..., None], cand, big)
    cand = cand.reshape(n, c, k_blocks * bs)

    # Second selection stage, two-level: a flat searchsorted over all
    # k_blocks*bs candidates costs O(K * k_blocks*bs) compares (~430M at
    # K=127 — it dominated the whole op); instead find the k-th peak's
    # BLOCK via per-block counts (K * k_blocks), then its slot within the
    # 128-wide block via a local rank (K * bs).  ~60x fewer compares.
    ranks = jnp.arange(1, max_peaks + 1, dtype=jnp.int32)
    cand_blocks = cand.reshape(n, c, k_blocks, bs)
    blk_counts = (cand_blocks < big).sum(axis=-1)       # [N,C,B]
    cum_bc = jnp.cumsum(blk_counts, axis=-1)            # inclusive
    b_id = jnp.minimum(_searchsorted_rows(cum_bc, ranks), k_blocks - 1)
    # one-hot masked reductions over the candidate-block axis instead of
    # [N,C,K] single-element gathers.
    b_onehot = b_id[..., None] == jnp.arange(k_blocks)  # [N,C,K,B]
    before = jnp.sum(jnp.where(
        b_onehot, (cum_bc - blk_counts)[..., None, :], 0), axis=-1)
    local_rank = ranks - before                         # [N,C,K], >= 1
    sel = jnp.take_along_axis(cand_blocks, b_id[..., None], axis=2)
    local_cum = jnp.cumsum((sel < big).astype(jnp.int32), axis=-1)
    pos = jnp.minimum(
        jnp.sum(local_cum < local_rank[..., None], axis=-1), bs - 1)
    pos_onehot = pos[..., None] == jnp.arange(bs)       # [N,C,K,bs]
    peak_idx = jnp.sum(jnp.where(pos_onehot, sel, 0),
                       axis=-1)                         # [N,C,max_peaks]
    valid = peak_idx < big
    count = valid.sum(axis=-1).astype(jnp.float32)      # [N,C]
    peak_idx = jnp.where(valid, peak_idx, 0)

    def refined(k):
        """Refine the leading k slots, zero-pad the rest (exact when the
        true count <= k everywhere).  One path for every tier: the
        band-matmul formulation ties the windowed gather at k=16 and is
        2.5x faster at the full 127 budget (see _refine_dense)."""
        x_ref, y_ref, value = _refine_dense(heat, peak_idx[:, :, :k],
                                            offset)
        vk = valid[:, :, :k]
        peaks_k = jnp.stack([jnp.where(vk, x_ref, 0.0),
                             jnp.where(vk, y_ref, 0.0),
                             jnp.where(vk, value, 0.0)], axis=-1)
        return jnp.pad(peaks_k,
                       ((0, 0), (0, 0), (0, max_peaks - k), (0, 0)))

    tiers = tuple(k for k in sorted(fast_peaks) if 0 < k < max_peaks)
    if not tiers:
        peaks = refined(max_peaks)
    else:
        max_count = jnp.max(count)

        def tiered(remaining):
            if not remaining:
                return lambda _: refined(max_peaks)
            k = remaining[0]
            return lambda _: jax.lax.cond(
                max_count <= k, lambda __: refined(k),
                tiered(remaining[1:]), 0)
        peaks = tiered(tiers)(0)

    header = jnp.zeros((n, c, 1, 3), jnp.float32).at[:, :, 0, 0].set(count)
    return jnp.concatenate([header, peaks], axis=2)
