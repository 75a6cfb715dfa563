"""A `torch.profiler` trace of the measured window, reduced to what the
per-layer metrics and the breakdown read: the seconds in which anything ran
on the device (the union of its activities' intervals), each device
operation's total seconds by name, and the longest idle gaps, each named by
what the host was doing at its middle (the benchmark's own span and the
innermost host operation)."""
from __future__ import annotations

import collections
import re

import numpy as np

SPAN_PREFIX = "bench/"


class _Session:
    """A `torch.profiler` trace of host and device activities, read back as
    the raw kineto events (not the profiler's parsed event tree)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def events(self):
        results = self.prof.profiler.kineto_results
        return results.events() if results else []


def start() -> _Session:
    return _Session()


def stop(session: _Session) -> None:
    session.stop()


def short_name(name: str) -> str:
    """A kernel's name without its argument list and template arguments."""
    if not name.startswith(("Memcpy", "Memset")):
        name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
        name = re.sub(r"<.*>", "<>", name)
    return name.strip()[:120]


def reduce(session: _Session, top: int = 10) -> dict:
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    dev_start, dev_end, by_name = [], [], collections.defaultdict(float)
    host_start, host_end, host_events = [], [], []
    for e in session.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if _annotation(e):
                continue  # a host range mirrored on the device's timeline, not work
            dev_start.append(s)
            dev_end.append(s + d)
            by_name[e.name()] += d * 1e-9
        else:
            host_start.append(s)
            host_end.append(s + d)
            host_events.append(e)
    if not dev_start:
        return {"busy_s": 0.0, "kernel_s": {}, "device_ops": [], "idle_gaps": []}
    ds, de = np.asarray(dev_start), np.asarray(dev_end)
    order = np.argsort(ds, kind="stable")
    ds, de = ds[order], de[order]
    reach = np.maximum.accumulate(de)
    # a new busy interval starts where an activity starts after all before it ended
    new = np.concatenate([[True], ds[1:] > reach[:-1]])
    starts = ds[new]
    ends = np.concatenate([reach[np.flatnonzero(new)[1:] - 1], reach[-1:]])
    busy_s = float((ends - starts).sum()) * 1e-9
    hs, he = np.asarray(host_start), np.asarray(host_end)
    lo = min(int(starts[0]), int(hs.min())) if len(hs) else int(starts[0])
    hi = max(int(ends[-1]), int(he.max())) if len(he) else int(ends[-1])
    gap_lo = np.concatenate([[lo], ends])
    gap_hi = np.concatenate([starts, [hi]])
    width = gap_hi - gap_lo
    gaps = []
    for i in np.argsort(-width, kind="stable")[:top]:
        if width[i] <= 0:
            break
        gaps.append([_host_at(hs, he, host_events, (gap_lo[i] + gap_hi[i]) // 2),
                     float(width[i]) * 1e-9])
    ops = collections.defaultdict(float)
    for name, sec in by_name.items():
        ops[short_name(name)] += sec
    return {
        "busy_s": busy_s,
        "kernel_s": dict(by_name),
        "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": gaps,
    }


def _annotation(e) -> bool:
    """Whether a device-side event is a user annotation (the benchmark's
    spans, ``nccl:all_reduce``): a range the host opened, which the profiler
    mirrors on the device's timeline over the work inside it."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return "annotation" in str(kind) or e.name().startswith((SPAN_PREFIX, "nccl:"))


def _host_at(hs, he, events, t) -> str:
    if not len(hs):
        return "no host activity"
    idx = np.flatnonzero((hs <= t) & (he >= t))
    if not len(idx):
        return "between host operations"
    names = {i: events[i].name() for i in idx}
    spans = [i for i in idx if names[i].startswith(SPAN_PREFIX)]
    ops = [i for i in idx if not names[i].startswith(SPAN_PREFIX)]
    span = max(spans, key=lambda i: hs[i]) if spans else None
    inner = max(ops, key=lambda i: hs[i]) if ops else None
    parts = [names[i] for i in (span, inner) if i is not None]
    return " > ".join(parts)[:160]


def kernel_seconds(kernel_s: dict, pattern: str) -> float:
    """Total seconds of the device operations whose name holds one of the
    identifiers of ``pattern`` (a regex alternation) as a whole word."""
    rx = re.compile(rf"(?<![A-Za-z0-9_])(?:{pattern})(?![A-Za-z0-9_])")
    return sum(v for k, v in kernel_s.items() if rx.search(k))
