"""Deterministic fault injection for chaos-testing the out-of-core stack.

Counterpart of `repro.fault.inject`, a copy: the port keeps its own
process-global plan, so a plan installed here fires only in `repro_torch`.

A `FaultPlan` is a seeded, serializable list of `FaultSpec`s, each naming a
*site* (a string fired from instrumented code), a call-count window, and an
action (raise / kill / delay). The plan is installed process-globally; the
instrumented hot paths call :func:`fire`, which is a single module-attribute
load plus a ``None`` check when nothing is installed — the "off by default,
zero overhead" contract. Sites live at I/O granularity (one fire per page
read/write), never per row.

Instrumented sites of the port:

  "page_store.read_page"        ctx: index          (repro_torch.data.pages)
  "page_store.write_page"       ctx: index
  "page_store.decode"           ctx: index, codec   (post-CRC decode; a
                                planted or natural failure here surfaces
                                as the non-retryable PageDecodeError)
  "elastic.rpc"                 ctx: worker, op     (repro_torch.distributed
                                .elastic_worker, before each op)
  "elastic.worker.iteration"    ctx: worker, iteration  (at each begin_tree)
  "hist_store.fetch"            ctx: -              (repro_torch.core
                                .histcache, once per staging try)

Triggering is deterministic by construction: each site keeps a call counter
and a spec fires when the counter lands in ``[at, at + count)`` (``count=-1``
means "from `at` on, forever") and every ``match`` item equals the fired
context. Two runs that make the same calls hit the same faults — the chaos
test's reproducibility rests on exactly this.

The plan crosses process boundaries as JSON in the ``REPRO_FAULT_PLAN``
environment variable (:func:`install_from_env`), for the elastic trainer's
subprocess workers.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Iterable

ENV_VAR = "REPRO_FAULT_PLAN"

ACTIONS = ("raise", "kill", "delay")

_EXC_TYPES: dict[str, type[BaseException]] = {
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire `action` at `site` on calls [at, at+count).

    Parameters
    ----------
    site : the instrumented site name (see module docstring).
    at : 1-based call count at which the fault starts firing.
    count : how many consecutive calls fire (-1 = every call from `at` on).
    action : "raise" (throw `exc`), "kill" (``os._exit(exit_code)`` — a hard
        crash no ``finally`` can intercept, the honest worker-death model), or
        "delay" (sleep `delay_s` before proceeding — models a hung disk or a
        stalled collective that the caller's timeout must catch).
    exc : exception type name for "raise" (one of OSError, TimeoutError,
        ConnectionError, RuntimeError, ValueError).
    message : exception message for "raise".
    delay_s : sleep for "delay".
    exit_code : process exit code for "kill".
    match : optional context filter — every key must equal the fired site's
        context (e.g. {"worker": "w1", "iteration": 3}).
    """

    site: str
    at: int = 1
    count: int = 1
    action: str = "raise"
    exc: str = "OSError"
    message: str = "injected fault"
    delay_s: float = 0.0
    exit_code: int = 137
    match: dict[str, Any] | None = None

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"action must be one of {ACTIONS}; got {self.action!r}")
        if self.action == "raise" and self.exc not in _EXC_TYPES:
            raise ValueError(
                f"exc must be one of {sorted(_EXC_TYPES)}; got {self.exc!r}"
            )
        if self.at < 1:
            raise ValueError(f"at is a 1-based call count; got {self.at}")
        if self.count < -1 or self.count == 0:
            raise ValueError(f"count must be positive or -1 (forever); got {self.count}")

    def triggers(self, n: int, ctx: dict[str, Any]) -> bool:
        """Does this spec fire on the n-th call (1-based) with context ctx?"""
        if n < self.at:
            return False
        if self.count != -1 and n >= self.at + self.count:
            return False
        if self.match:
            for key, want in self.match.items():
                if ctx.get(key) != want:
                    return False
        return True


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded set of `FaultSpec`s — the serializable unit of chaos.

    ``seed`` keeps a reproducibility handle on the plan (it names the chaos
    scenario and seeds any future randomized action); triggering itself is
    already deterministic via call counts.
    """

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    @classmethod
    def of(cls, *specs: FaultSpec, seed: int = 0) -> "FaultPlan":
        return cls(specs=tuple(specs), seed=seed)

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs],
            }
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        return cls(
            specs=tuple(FaultSpec(**s) for s in data.get("specs", ())),
            seed=int(data.get("seed", 0)),
        )


class FaultInjector:
    """Per-process spec matcher: counts calls per site, fires planned faults.

    Thread-safe: `Prefetcher` fires from its worker thread while the consumer
    fires from the main thread. ``fired`` records every (site, call_n, spec)
    that actually triggered — tests assert against it.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: list[tuple[str, int, FaultSpec]] = []
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._by_site: dict[str, list[FaultSpec]] = {}
        for spec in plan.specs:
            self._by_site.setdefault(spec.site, []).append(spec)

    def call_count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def fire(self, site: str, **ctx: Any) -> None:
        """Count one call at `site`; execute any spec whose window it hits."""
        specs = self._by_site.get(site)
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            if not specs:
                return
            hits = [s for s in specs if s.triggers(n, ctx)]
            for s in hits:
                self.fired.append((site, n, s))
        # act outside the lock: delay sleeps, kill never returns
        for s in hits:
            self._act(s, site, n)

    def _act(self, spec: FaultSpec, site: str, n: int) -> None:
        if spec.action == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.action == "kill":
            # os._exit, not sys.exit: a real crash skips atexit/finally — the
            # coordinator must detect it from outside, which is the point
            os._exit(spec.exit_code)
        raise _EXC_TYPES[spec.exc](f"{spec.message} [site={site} call={n}]")


# ---------------------------------------------------------------- global hook
# The module global IS the off-switch: `fire` below does one attribute load
# and a None check when no plan is installed, so instrumented hot paths pay
# nothing measurable in normal runs.
_injector: FaultInjector | None = None


def install(plan: FaultPlan | FaultInjector) -> FaultInjector:
    """Install a plan process-globally; returns the live injector."""
    global _injector
    _injector = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    return _injector


def uninstall() -> None:
    global _injector
    _injector = None


def get_injector() -> FaultInjector | None:
    return _injector


def fire(site: str, **ctx: Any) -> None:
    """The instrumented-code hook: no-op unless a plan is installed."""
    inj = _injector
    if inj is not None:
        inj.fire(site, **ctx)


def install_from_env(environ: os._Environ | dict | None = None) -> FaultInjector | None:
    """Install the plan serialized in ``REPRO_FAULT_PLAN``, if any.

    Called by subprocess entry points so a coordinator-authored plan reaches
    the worker that must crash.
    """
    env = environ if environ is not None else os.environ
    text = env.get(ENV_VAR)
    if not text:
        return None
    return install(FaultPlan.from_json(text))


class injected:
    """Context manager for test-scoped injection: installs on enter,
    uninstalls on exit (even when the injected fault propagates)."""

    def __init__(self, plan: FaultPlan | Iterable[FaultSpec]):
        if not isinstance(plan, FaultPlan):
            plan = FaultPlan(specs=tuple(plan))
        self.plan = plan
        self.injector: FaultInjector | None = None

    def __enter__(self) -> FaultInjector:
        self.injector = install(self.plan)
        return self.injector

    def __exit__(self, *exc_info) -> None:
        uninstall()
