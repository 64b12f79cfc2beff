"""Pipelined full evaluation (impx/eval/pipeline.py): the reader, the matcher
and the evaluator overlap, and the results equal the serial `evaluate_full`.

  reader thread   : reads, pads and normalizes a whole batch of pairs at a
                    time into a bounded prefetch queue, so host reads overlap
                    the matcher.
  matcher (main)  : one batched `produce_matches` call per batch.
  evaluator pool  : per-pair pose and metrics on a thread pool (cv2's USAC
                    and the device's kernels run without the interpreter
                    lock); results are drained in submission order, so the
                    accumulation is the serial evaluate_full's.

Two departures from impx: each pair's pose draws from its own generator,
seeded from (seed, pair index), so the results do not depend on the order in
which the threads run (impx's threads share one key); and when the consume
loop raises, a `finally` stops the reader, drains the queue and joins the
reader thread (impx leaves the thread behind).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from impx_torch.data.reader import round_up
from impx_torch.eval.eval_full import (eval_payload, matched_points, pair_feed, produce_indices,
                                       split_opt, summary)
from impx_torch.eval.evaluator import AucEval


def _stage_batch(reader, indices, bucket: int):
    """Read, pad and normalize the pairs of `indices`: (stacked numpy feed,
    infos, padded keypoints (x0, x1) per pair)."""
    feeds, infos, raw = [], [], []
    for index in indices:
        info = reader.run(index)
        feed, x0, x1 = pair_feed(info, bucket)
        feeds.append(feed)
        infos.append(info)
        raw.append((x0, x1))
    return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}, infos, raw


def evaluate_full_pipelined(model, opt: dict, dataset: str = "yfcc", feat_type: str = "spp",
                            max_pairs: int = -1, batch_size: int = 4, prefetch: int = 3,
                            eval_workers: int = 4) -> dict:
    """Three-stage overlapped evaluate_full; the same inputs and results."""
    from impx_torch.data.reader import StandardReader

    read_cfg, eval_cfg = split_opt(opt, dataset)
    evaluator = AucEval(eval_cfg, device=model.device)
    reader = StandardReader(read_cfg)
    bucket = round_up(reader.num_kpt, 128)
    n = len(reader) if max_pairs < 0 else min(max_pairs, len(reader))
    th = eval_cfg.get("ransac_th", 1.0)

    staged: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def reader_loop():
        try:
            for start in range(0, n, batch_size):
                if stop.is_set():
                    return
                indices = list(range(start, min(start + batch_size, n)))
                # repeat the last pair so that every batch has one shape
                full = indices + [indices[-1]] * (batch_size - len(indices))
                staged.put((_stage_batch(reader, full, bucket), len(indices)))
        except Exception as exc:  # handed to the consumer, which raises it
            staged.put(exc)
        finally:
            staged.put(None)

    thread = threading.Thread(target=reader_loop, daemon=True)
    thread.start()
    try:
        futures = []
        with ThreadPoolExecutor(max_workers=eval_workers) as pool:
            while (item := staged.get()) is not None:
                if isinstance(item, Exception):
                    raise item
                (feed, infos, raw), n_real = item
                indices0 = produce_indices(model, feed)  # [B, bucket]
                for b in range(n_real):
                    corr1, corr2 = matched_points(*raw[b], indices0[b], bucket)
                    futures.append(pool.submit(evaluator.run, eval_payload(infos[b], corr1, corr2), th=th))
            # drain in submission order: serial evaluate_full's accumulation
            for fut in futures:
                evaluator.res_inqueue(fut.result())
    finally:
        stop.set()
        while thread.is_alive():  # unblock a reader waiting on a full queue
            try:
                staged.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()
        reader.close()
    return summary(evaluator)
