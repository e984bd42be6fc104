"""Scalar NumPy oracles transcribing the reference CPU/CUDA semantics.

These are deliberately slow, loop-based transliterations of the algorithm
descriptions (cited per function) used as ground truth for the vectorized
device ops.  They live in tests/ only.
"""

from __future__ import annotations

import numpy as np


def iround(a: float) -> int:
    """positiveIntRound (include/openpose/utilities/fastMath.hpp)."""
    return int(a + 0.5)


def nms_oracle(heat: np.ndarray, threshold: float, max_peaks: int,
               offset=(0.5, 0.5)) -> np.ndarray:
    """nmsCpu (src/openpose/net/nmsBase.cpp:110-170) for one [H, W] channel.
    Returns [max_peaks+1, 3]."""
    h, w = heat.shape
    kernel = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            v = heat[y, x]
            if 1 < x < w - 2 and 1 < y < h - 2:
                if v > threshold:
                    nbs = [heat[y + dy, x + dx]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                           if not (dx == 0 and dy == 0)]
                    kernel[y, x] = int(all(v > nb for nb in nbs))
            elif x == 1 or x == w - 2 or y == 1 or y == h - 2:
                if v > threshold:
                    nbs = []
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            if dx == 0 and dy == 0:
                                continue
                            yy, xx = y + dy, x + dx
                            nbs.append(heat[yy, xx]
                                       if 0 <= yy < h and 0 <= xx < w
                                       else threshold)
                    kernel[y, x] = int(all(v >= nb for nb in nbs))
    target = np.zeros((max_peaks + 1, 3), np.float32)
    count = 0
    for y in range(h):
        for x in range(w):
            if count < max_peaks and kernel[y, x] == 1:
                x_acc = y_acc = s_acc = 0.0
                for dy in range(-3, 4):
                    yy = y + dy
                    if 0 <= yy < h:
                        for dx in range(-3, 4):
                            xx = x + dx
                            if 0 <= xx < w:
                                s = heat[yy, xx]
                                if s > 0:
                                    x_acc += xx * s
                                    y_acc += yy * s
                                    s_acc += s
                target[count + 1] = (x_acc / s_acc + offset[0],
                                     y_acc / s_acc + offset[1], heat[y, x])
                count += 1
    target[0, 0] = count
    return target


def paf_score_oracle(ax, ay, bx, by, map_x, map_y, inter_threshold,
                     inter_min_above, default_nms_threshold) -> float:
    """process() (src/openpose/net/bodyPartConnectorBase.cu:15-67)."""
    h, w = map_x.shape
    vx, vy = bx - ax, by - ay
    linf = max(abs(vx), abs(vy))
    n = max(5, min(25, iround(np.sqrt(5 * linf))))
    norm = float(np.sqrt(vx * vx + vy * vy))
    if norm > 1e-6:
        ux, uy = vx / norm, vy / norm
        s = 0.0
        cnt = 0
        for lm in range(n):
            mx = min(w - 1, iround(ax + lm * vx / n))
            my = min(h - 1, iround(ay + lm * vy / n))
            score = ux * map_x[my, mx] + uy * map_y[my, mx]
            if score > inter_threshold:
                s += score
                cnt += 1
        if cnt / n > inter_min_above:
            return s / cnt
        if norm < np.sqrt(float(w * h)) / 150:
            return default_nms_threshold + 1e-6
    return -1.0 if norm > 1e-6 else -1.0


def cubic_resize_oracle(src: np.ndarray, th: int, tw: int,
                        scale_h=None, scale_w=None) -> np.ndarray:
    """bicubicInterpolate over the full target grid
    (include/openpose_private/gpu/cuda.hu:92-144,
    src/openpose/net/resizeAndMergeBase.cu:36-54)."""
    h, w = src.shape
    if scale_h is None:
        scale_h = th / h
    if scale_w is None:
        scale_w = tw / w
    out = np.zeros((th, tw), np.float32)

    def cubic(v0, v1, v2, v3, d):
        return ((-0.5 * v0 + 1.5 * v1 - 1.5 * v2 + 0.5 * v3) * d ** 3
                + (v0 - 2.5 * v1 + 2.0 * v2 - 0.5 * v3) * d ** 2
                - 0.5 * (v0 - v2) * d + v1)

    for y in range(th):
        ys = (y + 0.5) / scale_h - 0.5
        y1 = min(max(int(np.floor(ys)), 0), h - 1)
        y0 = max(0, y1 - 1)
        y2 = min(h - 1, y1 + 1)
        y3 = min(h - 1, y2 + 1)
        dy = ys - y1
        for x in range(tw):
            xs = (x + 0.5) / scale_w - 0.5
            x1 = min(max(int(np.floor(xs)), 0), w - 1)
            x0 = max(0, x1 - 1)
            x2 = min(w - 1, x1 + 1)
            x3 = min(w - 1, x2 + 1)
            dx = xs - x1
            tmp = [cubic(src[yy, x0], src[yy, x1], src[yy, x2], src[yy, x3], dx)
                   for yy in (y0, y1, y2, y3)]
            out[y, x] = cubic(tmp[0], tmp[1], tmp[2], tmp[3], dy)
    return out
