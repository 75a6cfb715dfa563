"""Deterministic fault injection and the shared retry/backoff policy.

Counterpart of `repro.fault`: `inject` plants reproducible faults at the
port's I/O sites (chaos tests), `retry` absorbs the transient ones.
"""
from repro_torch.fault.inject import (
    ENV_VAR,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    fire,
    get_injector,
    injected,
    install,
    install_from_env,
    uninstall,
)
from repro_torch.fault.retry import RetryPolicy

__all__ = [
    "ENV_VAR",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "RetryPolicy",
    "fire",
    "get_injector",
    "injected",
    "install",
    "install_from_env",
    "uninstall",
]
