"""Kernel-level parity tests: vectorized device ops vs scalar reference oracles."""

import jax.numpy as jnp
import numpy as np
import pytest

from openpose_tpu.ops import assembly, nms, paf, resize
from tests import oracle


def _random_heat(h, w, n_blobs, seed):
    rng = np.random.RandomState(seed)
    heat = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(n_blobs):
        cy, cx = rng.uniform(2, h - 3), rng.uniform(2, w - 3)
        amp = rng.uniform(0.3, 1.0)
        heat += amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 4.0)
    heat += rng.uniform(-0.02, 0.02, heat.shape).astype(np.float32)
    return heat.astype(np.float32)


class TestNms:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_oracle(self, seed):
        h, w = 40, 56
        heat = _random_heat(h, w, 6, seed)
        want = oracle.nms_oracle(heat, 0.05, 127)
        got = np.asarray(nms.nms(heat[None, :, :, None], 0.05, 127))[0, 0]
        assert got[0, 0] == want[0, 0], "peak count mismatch"
        n = int(want[0, 0])
        np.testing.assert_allclose(got[1:n + 1], want[1:n + 1],
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("seed", [0, 3])
    def test_dense_full_budget_matches_oracle(self, seed):
        """The k>48 tier refines via dense box sums (ops/nms._refine_dense)
        instead of windowed gathers; a many-peak map with tiers disabled
        must still match the scalar oracle at the full 127 budget."""
        h, w = 72, 104
        heat = _random_heat(h, w, 110, seed)      # dozens of peaks
        want = oracle.nms_oracle(heat, 0.05, 127)
        got = np.asarray(nms.nms(heat[None, :, :, None], 0.05, 127,
                                 fast_peaks=()))[0, 0]
        assert got[0, 0] == want[0, 0], "peak count mismatch"
        n = int(want[0, 0])
        assert n > 48, "test must exercise the dense tier"
        np.testing.assert_allclose(got[1:n + 1], want[1:n + 1],
                                   rtol=1e-4, atol=1e-4)

    def test_border_rules(self):
        # Peak on the first inner border uses >= (plateau allowed)
        heat = np.zeros((12, 12), np.float32)
        heat[1, 1] = 0.5
        got = np.asarray(nms.nms(heat[None, :, :, None], 0.05, 10))[0, 0]
        assert got[0, 0] == 1
        # Peak on the outermost border is never registered
        heat2 = np.zeros((12, 12), np.float32)
        heat2[0, 5] = 0.9
        got2 = np.asarray(nms.nms(heat2[None, :, :, None], 0.05, 10))[0, 0]
        assert got2[0, 0] == 0

    def test_small_map_last_block_no_duplicates(self):
        # Regression: when the map has fewer nonempty 128-px blocks than
        # k_blocks, the clamped block selections land on the LAST block,
        # which for small maps can hold real peaks — those duplicated
        # selections must not inflate the count or emit duplicate peaks.
        h, w = 24, 24                      # 576 px -> 5 blocks, k_blocks=5
        heat = np.zeros((h, w), np.float32)
        heat[21, 10] = 0.9                 # flat idx 514: inside block 4
        got = np.asarray(nms.nms(heat[None, :, :, None], 0.05, 127))[0, 0]
        want = oracle.nms_oracle(heat, 0.05, 127)
        assert got[0, 0] == want[0, 0] == 1
        np.testing.assert_allclose(got[1], want[1], atol=1e-4)
        # and a fuller small map still matches the oracle exactly
        heat2 = _random_heat(h, w, 5, seed=7)
        got2 = np.asarray(nms.nms(heat2[None, :, :, None], 0.05, 127))[0, 0]
        want2 = oracle.nms_oracle(heat2, 0.05, 127)
        assert got2[0, 0] == want2[0, 0]
        n = int(want2[0, 0])
        np.testing.assert_allclose(got2[1:n + 1], want2[1:n + 1],
                                   rtol=1e-4, atol=1e-4)

    def test_max_peaks_cap(self):
        heat = np.zeros((30, 30), np.float32)
        for y in range(2, 28, 3):
            for x in range(2, 28, 3):
                heat[y, x] = 1.0
        got = np.asarray(nms.nms(heat[None, :, :, None], 0.05, 5))[0, 0]
        assert got[0, 0] == 5
        want = oracle.nms_oracle(heat, 0.05, 5)
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestChannelArgmax:
    def _gaussian_maps(self, n, h, w, c, seed, lo=8.0, sigma=7.0):
        rng = np.random.RandomState(seed)
        gridx = (np.arange(w) + 0.5) * 8 - 0.5
        gridy = (np.arange(h) + 0.5) * 8 - 0.5
        maps = np.zeros((n, h, w, c), np.float32)
        for i in range(n):
            for ch in range(c):
                gx = rng.uniform(lo, 8 * w - 1 - lo)
                gy = rng.uniform(lo, 8 * h - 1 - lo)
                d2 = ((gridx[None, :] - gx) ** 2
                      + (gridy[:, None] - gy) ** 2)
                maps[i, :, :, ch] = (np.exp(-d2 / (2 * sigma * sigma))
                                     + 0.01 * rng.randn(h, w))
        return maps

    def test_refined_equals_full_upsample_interior(self):
        """channel_argmax_refined must reproduce the reference decode
        (8x bicubic upsample -> argmax, faceExtractorCaffe.cpp:230-310)
        bit-exactly for interior peaks."""
        from openpose_tpu.ops import maximum
        maps = self._gaussian_maps(4, 24, 30, 13, seed=0)
        full = np.asarray(maximum.channel_argmax(
            resize.resize_bicubic(jnp.asarray(maps), (24 * 8, 30 * 8))))
        fast = np.asarray(maximum.channel_argmax_refined(jnp.asarray(maps)))
        np.testing.assert_array_equal(full[..., :2], fast[..., :2])
        np.testing.assert_allclose(full[..., 2], fast[..., 2], atol=1e-5)

    def test_refined_near_border_within_one_px(self):
        """Edge-clamped windows may differ from the full path's tap
        clamping by at most 1 upsampled px."""
        from openpose_tpu.ops import maximum
        maps = self._gaussian_maps(2, 24, 30, 13, seed=1, lo=0.0, sigma=3.0)
        full = np.asarray(maximum.channel_argmax(
            resize.resize_bicubic(jnp.asarray(maps), (24 * 8, 30 * 8))))
        fast = np.asarray(maximum.channel_argmax_refined(jnp.asarray(maps)))
        assert np.abs(full[..., :2] - fast[..., :2]).max() <= 1.0


class TestResize:
    @pytest.mark.parametrize("shape,target", [((6, 10), (48, 80)),
                                              ((9, 7), (36, 28))])
    def test_upsample_matches_oracle(self, shape, target):
        rng = np.random.RandomState(0)
        src = rng.randn(*shape).astype(np.float32)
        want = oracle.cubic_resize_oracle(src, *target)
        got = np.asarray(resize.resize_bicubic(
            src[None, :, :, None], target))[0, :, :, 0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_multi_scale_merge(self):
        rng = np.random.RandomState(1)
        s0 = rng.randn(6, 10).astype(np.float32)
        s1 = rng.randn(4, 8).astype(np.float32)
        ratios = [1.0, 0.7]
        target = (48, 80)
        got = np.asarray(resize.upsample_merge(
            [s0[None, :, :, None], s1[None, :, :, None]], ratios,
            target))[0, :, :, 0]
        w0 = oracle.cubic_resize_oracle(s0, *target)
        rel = ratios[1] / ratios[0]
        w1 = oracle.cubic_resize_oracle(
            s1, *target, scale_h=(target[0] / 6) / rel,
            scale_w=(target[1] / 10) / rel)
        np.testing.assert_allclose(got, (w0 + w1) / 2, rtol=1e-4, atol=1e-4)

    def test_fixed_aspect_downscale_pads_zero(self):
        img = np.full((1, 20, 30, 3), 100.0, np.float32)
        out = np.asarray(resize.resize_fixed_aspect(img, 0.5, (16, 16)))
        np.testing.assert_allclose(out[0, :10, :15], 100.0, atol=1e-3)
        np.testing.assert_allclose(out[0, 12:, :], 0.0, atol=1e-3)


class TestPafScores:
    def test_matches_oracle(self):
        h, w = 46, 46
        rng = np.random.RandomState(3)
        n_parts, max_peaks = 3, 8
        c = n_parts + 1 + 4  # parts + bkg + 2 pairs of PAF channels
        heat = rng.uniform(-1, 1, (1, h, w, c)).astype(np.float32)
        peaks = np.zeros((1, n_parts + 1, max_peaks + 1, 3), np.float32)
        counts = [3, 2, 4, 0]
        for part, cnt in enumerate(counts):
            peaks[0, part, 0, 0] = cnt
            for k in range(cnt):
                peaks[0, part, k + 1] = (rng.uniform(1, w - 2),
                                         rng.uniform(1, h - 2),
                                         rng.uniform(0.1, 1.0))
        pairs = np.array([[0, 1], [1, 2]], np.int32)
        map_idx = np.array([[4, 5], [6, 7]], np.int32)
        got = np.asarray(paf.paf_scores(
            heat, peaks, pairs, map_idx, 0.05, 0.5, 0.05))[0]
        for pi in range(2):
            pa, pb = pairs[pi]
            for i in range(max_peaks):
                for j in range(max_peaks):
                    if i < counts[pa] and j < counts[pb]:
                        want = oracle.paf_score_oracle(
                            peaks[0, pa, i + 1, 0], peaks[0, pa, i + 1, 1],
                            peaks[0, pb, j + 1, 0], peaks[0, pb, j + 1, 1],
                            heat[0, :, :, map_idx[pi, 0]],
                            heat[0, :, :, map_idx[pi, 1]], 0.05, 0.5, 0.05)
                    else:
                        want = -1.0
                    np.testing.assert_allclose(
                        got[pi, i, j], want, rtol=1e-4, atol=1e-5,
                        err_msg=f"pair {pi} peaks ({i},{j})")


class TestAssembly:
    def _toy_scene(self):
        """Two people, 3 parts chained 0-1-2, one spurious peak."""
        n_parts, max_peaks = 3, 5
        peaks = np.zeros((n_parts + 1, max_peaks + 1, 3), np.float32)
        # part 0: two peaks; part 1: two; part 2: two + spurious
        data = {0: [(10, 10, 0.9), (30, 10, 0.8)],
                1: [(10, 20, 0.85), (30, 20, 0.75)],
                2: [(10, 30, 0.7), (30, 30, 0.95), (50, 40, 0.3)]}
        for part, lst in data.items():
            peaks[part, 0, 0] = len(lst)
            for k, xyz in enumerate(lst):
                peaks[part, k + 1] = xyz
        pairs = np.array([[0, 1], [1, 2]], np.int32)
        scores = np.full((2, max_peaks, max_peaks), -1.0, np.float32)
        scores[0, 0, 0] = 0.9   # p0 person A
        scores[0, 1, 1] = 0.8   # p0 person B
        scores[1, 0, 0] = 0.7
        scores[1, 1, 1] = 0.85
        return scores, peaks, pairs

    def test_two_people(self):
        scores, peaks, pairs = self._toy_scene()
        kp, sc = assembly.connect_body_parts(
            scores, peaks, pairs, num_parts=3, min_subset_cnt=2,
            min_subset_score=0.1, scale_factor=2.0)
        assert kp.shape == (2, 3, 3)
        # People ordered by creation (highest total first)
        xs = sorted(kp[:, 0, 0].tolist())
        assert xs == [20.0, 60.0]  # scaled by 2
        assert (sc > 0).all()

    def test_merge_people(self):
        """Disjoint partial people merged by a later cross connection."""
        n_parts, max_peaks = 4, 3
        peaks = np.zeros((n_parts, max_peaks + 1, 3), np.float32)
        for part, (x, y) in enumerate([(5, 5), (5, 15), (5, 25), (5, 35)]):
            peaks[part, 0, 0] = 1
            peaks[part, 1] = (x, y, 0.9)
        pairs = np.array([[0, 1], [2, 3], [1, 2]], np.int32)
        scores = np.full((3, max_peaks, max_peaks), -1.0, np.float32)
        scores[0, 0, 0] = 0.9  # creates person 1
        scores[1, 0, 0] = 0.8  # creates person 2
        scores[2, 0, 0] = 0.5  # merges them
        kp, sc = assembly.connect_body_parts(
            scores, peaks, pairs, num_parts=4, min_subset_cnt=2,
            min_subset_score=0.1, scale_factor=1.0)
        assert kp.shape[0] == 1
        assert (kp[0, :, 2] > 0).all()

    def test_min_subset_filters(self):
        scores, peaks, pairs = self._toy_scene()
        kp, _ = assembly.connect_body_parts(
            scores, peaks, pairs, num_parts=3, min_subset_cnt=3,
            min_subset_score=10.0, scale_factor=1.0)
        # Nobody passes even the maximizePositives retry (score threshold huge)
        assert kp.shape[0] == 0


class TestPafProduction:
    """The production scoring chain — upsample_merge of every channel, then
    paf_scores gathers — against the scalar oracles: cubic_resize_oracle
    (resizeAndMerge) feeding paf_score_oracle (pafScoreKernel)."""

    def _scene(self, counts, max_peaks, seed=3, near_pair=False,
               border=False, zero_length=False):
        rng = np.random.RandomState(seed)
        n_parts = len(counts)
        c = n_parts + 1 + 6
        hs, ws = 11, 15
        th, tw = hs * 8, ws * 8
        src = rng.uniform(-1, 1, (2, hs, ws, c)).astype(np.float32)
        peaks = np.zeros((2, n_parts, max_peaks + 1, 3), np.float32)
        for b in range(2):
            for part, cnt in enumerate(counts):
                peaks[b, part, 0, 0] = cnt
                for k in range(cnt):
                    peaks[b, part, k + 1] = (rng.uniform(1, tw - 2),
                                             rng.uniform(1, th - 2),
                                             rng.uniform(0.1, 1.0))
        if near_pair:
            # close-keypoint fallback: |AB| < sqrt(W*H)/150
            peaks[0, 1, 1, :2] = peaks[0, 0, 1, :2] + 0.3
        if border:
            # samples at and beyond the map edge clamp to it
            peaks[0, 0, 1, :2] = (0.0, 0.0)
            peaks[0, 1, 1, :2] = (tw - 0.6, th - 0.6)
            peaks[1, 1, 2, :2] = (tw - 0.6, 0.0)
        if zero_length:
            # A == B: no direction, the pair scores -1
            peaks[0, 1, 1, :2] = peaks[0, 0, 1, :2]
        pairs = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
        map_idx = np.array([[n_parts + 1, n_parts + 2],
                            [n_parts + 3, n_parts + 4],
                            [n_parts + 1, n_parts + 4]], np.int32)
        return src, peaks, pairs, map_idx, (th, tw)

    @staticmethod
    def _check(sources, ratios, hw, peaks, pairs, map_idx):
        merged = resize.upsample_merge(
            [jnp.asarray(s) for s in sources], list(ratios), hw)
        got = np.asarray(paf.paf_scores(
            merged, jnp.asarray(peaks), jnp.asarray(pairs),
            jnp.asarray(map_idx), 0.05, 0.5, 0.05))
        th, tw = hw
        rel = [r / ratios[0] for r in ratios]
        for b in range(peaks.shape[0]):
            maps = {}
            for ch in np.unique(map_idx):
                acc = np.zeros((th, tw), np.float32)
                for s, r in zip(sources, rel):
                    sh, sw = s.shape[1], s.shape[2]
                    acc += oracle.cubic_resize_oracle(
                        s[b, :, :, ch], th, tw,
                        scale_h=(th / sources[0].shape[1]) / r,
                        scale_w=(tw / sources[0].shape[2]) / r)
                maps[ch] = acc / len(sources)
            for pi, (pa, pb) in enumerate(pairs):
                na, nb = int(peaks[b, pa, 0, 0]), int(peaks[b, pb, 0, 0])
                want = np.full(got.shape[2:], -1.0, np.float32)
                for i in range(na):
                    for j in range(nb):
                        want[i, j] = oracle.paf_score_oracle(
                            peaks[b, pa, i + 1, 0], peaks[b, pa, i + 1, 1],
                            peaks[b, pb, j + 1, 0], peaks[b, pb, j + 1, 1],
                            maps[map_idx[pi, 0]], maps[map_idx[pi, 1]],
                            0.05, 0.5, 0.05)
                np.testing.assert_allclose(got[b, pi], want, rtol=2e-3,
                                           atol=2e-4)

    @pytest.mark.parametrize("counts,kw", [
        ([4, 3, 2], {}),                          # typical sparse
        ([4, 3, 2], {"near_pair": True}),         # close-keypoint fallback
        ([12, 12, 12], {}),                       # saturated (== max_peaks)
        ([0, 3, 2], {}),                          # empty part
        ([4, 3, 2], {"border": True}),            # samples clamp at the edge
        ([4, 3, 2], {"zero_length": True}),       # A == B scores -1
    ])
    def test_matches_oracle(self, counts, kw):
        src, peaks, pairs, map_idx, hw = self._scene(counts, 12, **kw)
        self._check((src,), (1.0,), hw, peaks, pairs, map_idx)

    def test_two_scales_match_oracle(self):
        rng = np.random.RandomState(11)
        src, peaks, pairs, map_idx, hw = self._scene([5, 4, 3], 8)
        src2 = rng.uniform(-1, 1, (2, 8, 11, src.shape[-1])) \
            .astype(np.float32)
        self._check((src, src2), (1.0, 0.73), hw, peaks, pairs, map_idx)
