"""Request micro-batching for low-latency forest serving.

Counterpart of `repro.serve.batcher`, a copy: the batcher holds numpy rows
and futures and never touches the device itself.

Single-row requests are the worst case for an accelerator: every launch
costs the same overhead whether it predicts 1 row or 1024. `BatchServer`
coalesces concurrent `submit` calls into one padded batch per launch — a
batch leaves either when ``max_batch`` rows are waiting or when the oldest
request has waited ``max_delay_ms`` (the latency deadline), whichever comes
first. Batches are padded to ``max_batch`` rows so every launch has the same
shape; pad rows are sliced off before results are delivered.

``predict_fn`` runs on the batcher's worker thread. On a CUDA device that
thread launches the binning and forest kernels on its own current stream
(the kernels' wrappers read the calling thread's stream), and the copy of
the margins back to the host orders it before the results are delivered.

`ServeStats` is the serving-side ledger, mirroring what `TransferStats` does
for training traffic: per-request end-to-end latency quantiles (p50/p99),
batch occupancy (how full the launches run), padded-row overhead, sustained
rows/s, and the residency ledger the serving engine books.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class ServeStats:
    """Serving ledger: request latencies + batch shape accounting."""

    requests: int = 0
    batches: int = 0
    rows: int = 0  # real (non-pad) rows predicted
    padded_rows: int = 0  # pad rows added to fix the launch shape
    predict_seconds: float = 0.0  # time inside the model call
    wall_seconds: float = 0.0  # first submit -> last delivery
    latencies_s: list[float] = dataclasses.field(default_factory=list)
    # --- measured launch shapes (consumed by DeviceMemoryModel.serve_batch_rows
    # to size forest tree-chunks from real traffic instead of the worst-case
    # row page) ---
    max_launch_rows: int = 0  # biggest padded launch shape seen
    # --- residency ledger (filled by repro_torch.serve.engine when it serves with a
    # shared-budget DevicePageCache) ---
    predicts: int = 0  # engine-level predict calls served
    chunk_hits: int = 0  # forest tree-chunk launches served from residency
    chunk_misses: int = 0  # forest tree-chunks that had to stage
    h2d_bytes: int = 0  # host->device serving traffic (rows + chunks)

    def record_batch(self, n_rows: int, n_pad: int, predict_s: float,
                     latencies_s: Sequence[float]) -> None:
        self.batches += 1
        self.rows += n_rows
        self.padded_rows += n_pad
        self.predict_seconds += predict_s
        self.requests += len(latencies_s)
        self.latencies_s.extend(latencies_s)
        self.max_launch_rows = max(self.max_launch_rows, n_rows + n_pad)

    def record_residency(self, chunk_hits: int, chunk_misses: int,
                         h2d_bytes: int) -> None:
        """Book one engine predict's residency outcome (engine-side mirror of
        `record_batch`): chunk-cache hits/misses and the h2d bytes the call
        actually cost."""
        self.predicts += 1
        self.chunk_hits += chunk_hits
        self.chunk_misses += chunk_misses
        self.h2d_bytes += h2d_bytes

    def _quantile_ms(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), q)) * 1e3

    @property
    def p50_ms(self) -> float:
        return self._quantile_ms(50)

    @property
    def p99_ms(self) -> float:
        return self._quantile_ms(99)

    @property
    def occupancy(self) -> float:
        """Mean fraction of each launch that was real rows (0..1)."""
        launched = self.rows + self.padded_rows
        return self.rows / launched if launched else 0.0

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def chunk_hit_rate(self) -> float:
        """Forest tree-chunk launches served from device residency (0..1)."""
        total = self.chunk_hits + self.chunk_misses
        return self.chunk_hits / total if total else 0.0

    @property
    def h2d_bytes_per_request(self) -> float:
        """Host->device serving bytes amortized per request (per engine
        predict when no batcher traffic has been recorded)."""
        denom = self.requests or self.predicts
        return self.h2d_bytes / denom if denom else 0.0

    def reset(self) -> None:
        self.requests = self.batches = self.rows = self.padded_rows = 0
        self.predict_seconds = self.wall_seconds = 0.0
        self.latencies_s = []
        self.max_launch_rows = 0
        self.predicts = self.chunk_hits = self.chunk_misses = self.h2d_bytes = 0


class BatchServer:
    """Deadline-driven request coalescer over any batched ``predict_fn``.

    Parameters
    ----------
    predict_fn : (batch_rows, m) -> (batch_rows,) predictions. Typically
        ``PackedForest.predict_margin`` or a `ForestServer` method; anything
        batched works.
    max_batch : rows per launch; batches are padded up to exactly this many.
    max_delay_ms : how long the oldest queued request may wait for the batch
        to fill before the launch goes out anyway (the latency deadline).
    stats : `ServeStats` sink (a fresh ledger by default).

    ``submit`` returns a `concurrent.futures.Future`; ``predict_one`` is the
    blocking convenience wrapper. Use as a context manager (``close`` drains
    the queue and stops the worker).
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 256,
        max_delay_ms: float = 2.0,
        stats: ServeStats | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.stats = stats if stats is not None else ServeStats()
        self._queue: list[tuple[np.ndarray, Future, float]] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._t_first_submit: float | None = None
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client API
    def submit(self, row: np.ndarray) -> Future:
        """Enqueue one feature row; resolves to its prediction."""
        row = np.asarray(row)
        if row.ndim != 1:
            raise ValueError(f"submit takes a single feature row; got shape {row.shape}")
        fut: Future = Future()
        now = time.perf_counter()
        with self._wake:
            if self._closed:
                raise RuntimeError("BatchServer is closed")
            if self._t_first_submit is None:
                self._t_first_submit = now
            self._queue.append((row, fut, now))
            self._wake.notify()
        return fut

    def predict_one(self, row: np.ndarray, timeout: float | None = 30.0) -> float:
        return float(self.submit(row).result(timeout=timeout))

    def close(self) -> None:
        """Drain remaining requests, stop the worker, finalize wall time."""
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=60.0)

    def __enter__(self) -> "BatchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ worker loop
    def _take_batch(self) -> list[tuple[np.ndarray, Future, float]] | None:
        """Block until a batch is due (full, deadline hit, or closing)."""
        with self._wake:
            while True:
                if self._queue:
                    deadline = self._queue[0][2] + self.max_delay_s
                    if (
                        len(self._queue) >= self.max_batch
                        or self._closed
                        or time.perf_counter() >= deadline
                    ):
                        batch = self._queue[: self.max_batch]
                        del self._queue[: len(batch)]
                        return batch
                    self._wake.wait(timeout=max(deadline - time.perf_counter(), 0.0))
                elif self._closed:
                    return None
                else:
                    self._wake.wait()

    def _serve_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            rows = np.stack([r for r, _, _ in batch])
            n_pad = self.max_batch - rows.shape[0]
            if n_pad:  # one fixed launch shape for all traffic
                rows = np.concatenate(
                    [rows, np.zeros((n_pad, rows.shape[1]), rows.dtype)]
                )
            t0 = time.perf_counter()
            try:
                preds = np.asarray(self.predict_fn(rows))
            except Exception as e:  # deliver the failure to every waiter
                for _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            t_done = time.perf_counter()
            for i, (_, fut, t_submit) in enumerate(batch):
                fut.set_result(preds[i])
            self.stats.record_batch(
                len(batch), n_pad, t_done - t0,
                [t_done - t_submit for _, _, t_submit in batch],
            )
            if self._t_first_submit is not None:
                self.stats.wall_seconds = t_done - self._t_first_submit
