"""`RetryPolicy`: the one retry/backoff config shared by every I/O boundary.

Counterpart of `repro.fault.retry`, a copy. Long out-of-core runs cross
flaky boundaries — disk page reads (`Prefetcher`) today, histogram staging
and worker RPCs in later slices. `RetryPolicy` is the single place the
attempt budget and backoff curve live, threaded in via
`ExecutionPolicy.retry`.

Backoff is exponential with deterministic, seeded jitter: attempt k sleeps
``base_delay * multiplier**k`` scaled by a jitter factor drawn from a private
`random.Random(seed)` — no global RNG state touched, and two policies with the
same seed back off identically (reproducible chaos tests).

Accounting: every re-attempt increments ``stats.io_retries`` and every final
abort increments ``stats.io_giveups`` on the sink (duck-typed; `TransferStats`
carries both fields), so retry pressure is visible next to the transfer
ledger it degrades.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + exponential-backoff curve for one class of operation.

    Parameters
    ----------
    max_attempts : total tries including the first (1 = no retries).
    base_delay : sleep before the first retry, seconds.
    multiplier : backoff growth per retry (delay_k = base * multiplier**k).
    max_delay : backoff ceiling, seconds.
    jitter : fraction of each delay randomized away, in [0, 1]: the sleep is
        scaled by a factor drawn uniformly from [1 - jitter, 1]. Jitter is
        deterministic per policy instance (seeded), so runs reproduce.
    seed : seeds the jitter stream.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1; got {self.max_attempts}")
        if self.base_delay < 0:
            raise ValueError(f"base_delay must be >= 0; got {self.base_delay}")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1; got {self.multiplier}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1]; got {self.jitter}")

    def delays(self) -> list[float]:
        """The backoff schedule: sleep before retry k (len = max_attempts - 1)."""
        rng = random.Random(self.seed)
        out = []
        for k in range(self.max_attempts - 1):
            d = min(self.max_delay, self.base_delay * self.multiplier**k)
            out.append(d * (1.0 - self.jitter * rng.random()))
        return out

    def call(
        self,
        fn: Callable[[], Any],
        *,
        retryable: tuple[type[BaseException], ...] = (
            OSError,
            TimeoutError,
            ConnectionError,
        ),
        nonretryable: tuple[type[BaseException], ...] = (),
        stats: Any | None = None,
        sleep: Callable[[float], None] = time.sleep,
        describe: str = "operation",
        on_retry: Callable[[int, BaseException], None] | None = None,
    ) -> Any:
        """Run ``fn`` under this policy; re-raise the last error on give-up.

        ``stats`` is any sink with ``io_retries`` / ``io_giveups`` counters
        (`TransferStats`); ``sleep`` is injectable so tests pin the schedule
        without wall-clock cost. Exceptions outside ``retryable`` — or inside
        ``nonretryable``, which wins when the classes overlap (e.g. a
        deterministic `PageCorruptError` under a broad ``OSError`` net) —
        propagate immediately and are not counted as give-ups: they were
        never the transient class this policy exists for.
        """
        delays = self.delays()
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retryable as err:
                if nonretryable and isinstance(err, nonretryable):
                    raise
                last = err
                if attempt + 1 >= self.max_attempts:
                    if stats is not None:
                        stats.io_giveups += 1
                    raise
                if stats is not None:
                    stats.io_retries += 1
                if on_retry is not None:
                    on_retry(attempt, err)
                sleep(delays[attempt])
        raise last  # pragma: no cover - unreachable (loop always returns/raises)
