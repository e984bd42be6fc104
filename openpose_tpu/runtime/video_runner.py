"""Production throughput path: native decode -> batched device -> host tail.

Combines the pieces into the serving pipeline the reference builds with its
thread/queue graph (SURVEY §3.1), batched:

  NativeFramePump (C++ worker pool, ordered)  ->  fixed-size frame batches
  ->  ShardedPoseInference (one jitted program, data-parallel mesh)
  ->  thread-pool greedy assembly  ->  in-order consumer callback

Device dispatch is async: batch k+1 is decoded and submitted while batch k
executes and batch k-1 is assembled on the host pool.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from openpose_tpu.parallel.inference import ShardedPoseInference
from openpose_tpu.pose import scaler
from openpose_tpu.pose.extractor import PoseExtractor


@dataclasses.dataclass
class FrameResult:
    index: int
    keypoints: np.ndarray
    scores: np.ndarray
    source_wh: Tuple[int, int]


class VideoRunner:
    def __init__(self, inference: ShardedPoseInference,
                 extractor: PoseExtractor,
                 batch_size: int = 8, decode_threads: int = 4,
                 assembly_workers: int = 4, max_in_flight: int = 4):
        self.inference = inference
        self.extractor = extractor
        self.batch_size = batch_size
        self.decode_threads = decode_threads
        self.assembly_workers = assembly_workers
        # device batches in flight before the oldest is resolved; >2 hides
        # host<->device transfer latency behind compute
        self.max_in_flight = max(2, max_in_flight)

    def run_files(self, paths: List[str],
                  on_result: Optional[Callable[[FrameResult], None]] = None
                  ) -> List[FrameResult]:
        from openpose_tpu.io.native_loader import NativeFramePump, available
        if not available():
            raise RuntimeError("native frame pump not built (make -C native)")
        net_h, net_w = self.inference.net_hw
        pump = NativeFramePump(net_w, net_h, threads=self.decode_threads,
                               capacity=self.batch_size * 4)
        results: List[FrameResult] = []
        pool = concurrent.futures.ThreadPoolExecutor(self.assembly_workers)
        try:
            submitted = 0
            popped = 0
            pending_batches = []   # (start_idx, device_out, metas)
            assembly_futures = []

            def flush_batch(batch, metas, start_idx):
                # uint8 NHWC straight from the pump; device normalizes
                out = self.inference(np.stack(batch))
                handle = self.inference.fetch_begin(*out)
                pending_batches.append((start_idx, handle, list(metas)))

            def resolve_batch():
                start_idx, handle, metas = pending_batches.pop(0)
                peaks, scores = self.inference.fetch_end(handle)
                futs = []
                for bi, (scale, src_wh) in enumerate(metas):
                    s_n2o = 1.0 / scale if scale > 0 else 1.0
                    futs.append(pool.submit(
                        self._assemble_one, start_idx + bi, peaks[bi],
                        scores[bi], s_n2o, src_wh))
                assembly_futures.extend(futs)

            batch: List[np.ndarray] = []
            metas: List[Tuple[float, Tuple[int, int]]] = []
            start_idx = 0
            for path in paths:
                pump.submit_file(path)
                submitted += 1
                while pump.pending() > 0 and (submitted - popped) >= \
                        self.decode_threads:
                    item = pump.next(timeout_ms=50)
                    if item is None:
                        break
                    _, net_in, scale, src_wh = item
                    popped += 1
                    batch.append(net_in)
                    metas.append((scale, src_wh))
                    if len(batch) == self.batch_size:
                        flush_batch(batch, metas, start_idx)
                        start_idx += len(batch)
                        batch, metas = [], []
                        if len(pending_batches) >= self.max_in_flight:
                            resolve_batch()
            while popped < submitted:
                item = pump.next()
                if item is None:
                    raise IOError("decode timeout")
                _, net_in, scale, src_wh = item
                popped += 1
                batch.append(net_in)
                metas.append((scale, src_wh))
                if len(batch) == self.batch_size:
                    flush_batch(batch, metas, start_idx)
                    start_idx += len(batch)
                    batch, metas = [], []
            if batch:
                # pad the tail batch to the static batch size
                pad = self.batch_size - len(batch)
                real = len(batch)
                batch += [batch[-1]] * pad
                metas += [metas[-1]] * pad
                flush_batch(batch, metas, start_idx)
                start_idx += real
            while pending_batches:
                resolve_batch()
            for fut in assembly_futures:
                res = fut.result()
                if res.index < len(paths):
                    results.append(res)
                    if on_result is not None:
                        on_result(res)
        finally:
            pool.shutdown(wait=True)
            pump.close()
        results.sort(key=lambda r: r.index)
        return results

    def _assemble_one(self, index, peaks, scores, scale_net_to_output,
                      src_wh) -> FrameResult:
        keypoints, person_scores = self.extractor.assemble(
            peaks, scores, scale_net_to_output)
        return FrameResult(index, keypoints, person_scores, src_wh)

    # ------------------------------------------------------------------ #
    @staticmethod
    def run_video_whole_body(whole_body, path: str, frame_step: int = 1,
                             on_result=None, max_frames: int = -1,
                             batch_size: int = 8, decode_threads: int = 4):
        """Whole-body (pose+face+hand) batched video path.

        Feeds RAW decoded frames to ShardedWholeBody (its body stage does
        the per-scale resize on device, and the face/hand stages crop from
        the full-resolution frame exactly like the reference cascade,
        wrapperAuxiliary.hpp:324-337).  Batch-synchronous: the cascade has
        host geometry between device stages, so batches are not overlapped.

        Returns a list of (frame_index, WholeBodyResult).
        """
        from openpose_tpu.io.native_loader import NativeVideoPump, available
        if not available():
            raise RuntimeError("native frame pump not built (make -C native)")
        # net inputs from the pump are unused (resize happens on device)
        pump = NativeVideoPump(path, 16, 16, threads=decode_threads,
                               capacity=batch_size * 2,
                               frame_step=frame_step)
        results = []
        try:
            batch, idx0, n = [], 0, 0
            def flush(frames, start):
                real = len(frames)
                pad = batch_size - real
                frames = frames + [frames[-1]] * pad
                for off, res in enumerate(
                        whole_body(np.stack(frames))[:real]):
                    results.append((start + off, res))
                    if on_result is not None:
                        on_result(start + off, res)
            for _, frame, _net, _scale in pump:
                if 0 <= max_frames <= n:
                    break
                n += 1
                batch.append(frame)
                if len(batch) == batch_size:
                    flush(batch, idx0)
                    idx0 += batch_size
                    batch = []
            if batch:
                flush(batch, idx0)
        finally:
            pump.close()
        return results

    # ------------------------------------------------------------------ #
    def run_video(self, path: str, frame_step: int = 1,
                  on_result: Optional[Callable[[FrameResult], None]] = None,
                  max_frames: int = -1) -> List[FrameResult]:
        """Whole-video throughput path: native sequential decode + parallel
        preprocessing (NativeVideoPump) feeding batched device inference.

        Frames arrive via vp_next_batch: the C++ pump writes each device
        batch into ONE contiguous uint8 buffer (no per-frame ctypes calls,
        no original-frame copies, no np.stack) — the Python thread only
        dispatches device batches and assembly futures."""
        from openpose_tpu.io.native_loader import NativeVideoPump, available
        if not available():
            raise RuntimeError("native frame pump not built (make -C native)")
        net_h, net_w = self.inference.net_hw
        pump = NativeVideoPump(path, net_w, net_h,
                               threads=self.decode_threads,
                               capacity=self.batch_size * 4,
                               frame_step=frame_step)
        src_wh = pump.frame_size
        results: List[FrameResult] = []
        pool = concurrent.futures.ThreadPoolExecutor(self.assembly_workers)
        pending = []
        futures = []

        def flush(batch, scales, start_idx, real):
            out = self.inference(batch)
            handle = self.inference.fetch_begin(*out)
            pending.append((start_idx, handle, list(scales), real))

        def resolve():
            start_idx, handle, scales, real = pending.pop(0)
            pk, sc = self.inference.fetch_end(handle)
            for bi in range(real):
                s_n2o = 1.0 / scales[bi] if scales[bi] > 0 else 1.0
                futures.append(pool.submit(
                    self._assemble_one, start_idx + bi, pk[bi], sc[bi],
                    s_n2o, src_wh))

        try:
            start_idx = 0
            eof = False
            while not eof:
                want = self.batch_size
                if max_frames >= 0:
                    want = min(want, max_frames - start_idx)
                    if want <= 0:
                        break
                buf = np.empty((self.batch_size, net_h, net_w, 3), np.uint8)
                scl = np.empty((self.batch_size,), np.float64)
                got = 0
                while got < want:
                    item = pump.next_batch(want - got, out=buf[got:want])
                    if item is None:
                        eof = True
                        break
                    k, _, part_scales = item
                    scl[got:got + k] = part_scales[:k]
                    got += k
                if got == 0:
                    break
                if got < self.batch_size:       # pad the tail batch
                    buf[got:] = buf[got - 1]
                    scl[got:] = scl[got - 1]
                flush(buf, scl, start_idx, got)
                start_idx += got
                if len(pending) >= self.max_in_flight:
                    resolve()
            while pending:
                resolve()
            for fut in futures:
                res = fut.result()
                results.append(res)
                if on_result is not None:
                    on_result(res)
        finally:
            pool.shutdown(wait=True)
            pump.close()
        results.sort(key=lambda r: r.index)
        return results
