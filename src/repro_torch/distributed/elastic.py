"""Elastic fault-tolerant GBDT training over subprocess workers.

Counterpart of `repro.distributed.elastic`, with its own copy of the
framing and the worker handle. A coordinator and N data-parallel workers,
each streaming its own on-disk shard, run on plain ``subprocess`` + pipes,
so a worker that dies is a dead OS process, not a mocked exception. The
workers share the coordinator's device: on a card each opens its own CUDA
context there (the card's compute mode must allow several processes).

  the growth driver         the coordinator runs the driver of
                            `core.tree.tree_growth_driver` (depthwise or
                            lossguide) like every other builder; its HistFn
                            sums the per-shard histograms of one level
                            window or popped node's 2-node window, which the
                            workers return (kernel 4 with the plan's
                            ``node_map``, one launch per page) in
                            shard-id order, in numpy f32, so the total does
                            not depend on which worker serves a shard; its
                            PartitionFn broadcasts the split arrays and sums
                            the returned row counts. Split evaluation,
                            subtraction planning and tree layout run on the
                            coordinator's device, as in the single-process
                            builders.

  resume as the recovery    the coordinator checkpoints every iteration with
  primitive                 the atomic `GradientBooster.save`; when a worker
                            dies (exit-code watch, pipe EOF, heartbeat
                            staleness or RPC deadline) its shards go to the
                            least-loaded survivor and every worker reloads
                            its margins from the last durable checkpoint via
                            `GradientBooster.resume`, whose replay equals the
                            incremental margins bit for bit. Shard histograms
                            do not depend on the assignment, so the recovered
                            run grows the forest the uninterrupted run would.

Worker death injected by `repro_torch.fault` (the plan rides the
``REPRO_FAULT_PLAN`` environment variable into the worker subprocess) is how
the chaos tests script "kill worker w1 at iteration 3".

RPC discipline: requests carry a ``req_id`` and replies echo it, so a
timed-out request's late reply is discarded rather than mismatched. Worker
errors marked transient (I/O class) are retried under ``ElasticConfig.retry``;
every op the coordinator retries is idempotent (``begin_tree`` resets the
per-tree state, ``hist`` is a pure read, ``partition`` moves rows to
children no other pass has moved yet). ``finish_tree`` adds to the margins
and is never retried: if it fails, the coordinator recovers from the
checkpoint, which rebuilds the margins from scratch.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import select
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import objectives as obj_lib
from repro_torch.core.booster import (
    BoosterParams,
    GradientBooster,
    bin_valid_from_cuts,
    resolve_device,
)
from repro_torch.core.histcache import HistogramStore
from repro_torch.core.policy import sampling_requested
from repro_torch.core.quantile import HistogramCuts
from repro_torch.core.tree import TreeArrays, tree_growth_driver
from repro_torch.data.pages import TransferStats
from repro_torch.fault import inject as fault_inject
from repro_torch.fault.retry import RetryPolicy

_HDR = struct.Struct("!Q")
# the directory holding the `repro_torch` package: workers import the
# package the coordinator imported
_SRC_ROOT = str(Path(__file__).resolve().parents[2])


# ------------------------------------------------------------------- framing
def send_msg(fd: int, obj: Any) -> None:
    """Length-prefixed pickle frame onto a pipe fd (loops over short writes)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    data = _HDR.pack(len(payload)) + payload
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def recv_msg_blocking(fh) -> Any | None:
    """Read one frame from a buffered binary file; None on clean EOF."""
    hdr = fh.read(_HDR.size)
    if not hdr:
        return None
    if len(hdr) < _HDR.size:
        raise EOFError("truncated frame header")
    (size,) = _HDR.unpack(hdr)
    payload = fh.read(size)
    if len(payload) < size:
        raise EOFError("truncated frame payload")
    return pickle.loads(payload)


def _read_exact(fd: int, n: int, deadline: float) -> bytes:
    """Read exactly n bytes from fd before `deadline` (monotonic seconds)."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"deadline exceeded after {got}/{n} bytes")
        ready, _, _ = select.select([fd], [], [], min(remaining, 0.5))
        if not ready:
            continue
        chunk = os.read(fd, n - got)
        if not chunk:
            raise EOFError("pipe closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg_deadline(fd: int, deadline: float) -> tuple[Any, int]:
    """One frame from fd before `deadline`: (message, payload bytes)."""
    (size,) = _HDR.unpack(_read_exact(fd, _HDR.size, deadline))
    return pickle.loads(_read_exact(fd, size, deadline)), size


# ---------------------------------------------------------------- exceptions
class ElasticError(RuntimeError):
    """Unrecoverable elastic-training failure (budget exhausted, fatal op)."""


class WorkerFailure(ElasticError):
    """One worker is gone or unresponsive; recovery should handle it."""

    def __init__(self, worker: str, reason: str):
        self.worker = worker
        self.reason = reason
        super().__init__(f"worker {worker}: {reason}")


class TransientWorkerError(ElasticError):
    """The worker survived but an op hit a transient (I/O-class) error."""


class WorkerError(ElasticError):
    """The worker raised a deterministic application error; retrying or
    recovering cannot help — propagate with the worker's traceback."""


# -------------------------------------------------------------- worker handle
class WorkerHandle:
    """One subprocess worker: pipes, heartbeat file, request/reply framing."""

    def __init__(
        self,
        name: str,
        workdir: str,
        *,
        python: str | None = None,
        env_extra: dict[str, str] | None = None,
        heartbeat_interval: float = 0.5,
    ):
        self.name = name
        self.shards: list[int] = []
        self.broken = False
        self._req_id = 0
        self.last_reply_bytes = 0
        self.heartbeat_path = os.path.join(workdir, f"heartbeat_{name}")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC_ROOT, env.get("PYTHONPATH", "")) if p
        )
        env.update(env_extra or {})
        self.proc = subprocess.Popen(
            [
                python or sys.executable,
                "-m",
                "repro_torch.distributed.elastic_worker",
                "--name",
                name,
                "--heartbeat",
                self.heartbeat_path,
                "--heartbeat-interval",
                str(heartbeat_interval),
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
        )

    def alive(self) -> bool:
        return not self.broken and self.proc.poll() is None

    def heartbeat_age(self) -> float:
        try:
            return time.time() - os.path.getmtime(self.heartbeat_path)
        except OSError:
            return float("inf")

    def request(self, msg: dict, timeout: float) -> dict:
        """One RPC round-trip; raises `WorkerFailure` on death/deadline,
        `TransientWorkerError`/`WorkerError` on in-worker exceptions."""
        if not self.alive():
            raise WorkerFailure(self.name, f"not alive (exit code {self.proc.poll()})")
        self._req_id += 1
        msg = dict(msg, req_id=self._req_id)
        try:
            send_msg(self.proc.stdin.fileno(), msg)
        except (BrokenPipeError, OSError) as err:
            self.broken = True
            raise WorkerFailure(self.name, f"request pipe broke ({err})") from err
        deadline = time.monotonic() + timeout
        while True:
            try:
                reply, nbytes = recv_msg_deadline(self.proc.stdout.fileno(), deadline)
            except TimeoutError as err:
                # a hung worker holds no further promises: mark it broken so
                # recovery terminates and replaces it
                self.broken = True
                raise WorkerFailure(
                    self.name, f"rpc {msg.get('op')!r} timed out after {timeout}s"
                ) from err
            except (EOFError, OSError) as err:
                self.broken = True
                code = self.proc.poll()
                raise WorkerFailure(
                    self.name, f"died during rpc {msg.get('op')!r} (exit code {code})"
                ) from err
            if reply.get("req_id") == self._req_id:
                break
            # stale reply from an earlier timed-out request: discard
        self.last_reply_bytes = nbytes
        if "error" in reply:
            if reply.get("transient"):
                raise TransientWorkerError(f"{self.name}: {reply['error']}")
            raise WorkerError(
                f"{self.name}: {reply['error']}\n{reply.get('traceback', '')}"
            )
        return reply

    def terminate(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:  # pragma: no cover
                self.proc.kill()
                self.proc.wait()
        for fh in (self.proc.stdin, self.proc.stdout):
            try:
                fh.close()
            except OSError:  # pragma: no cover
                pass


# -------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the elastic orchestrator (everything time/failure related).

    ``rpc_timeout_s`` and ``heartbeat_timeout_s`` must cover a worker's
    start: its torch import, CUDA context and kernel load. ``respawn``
    False re-assigns a dead worker's shards to survivors (capacity shrinks,
    the run continues — "elastic"); True also spawns a replacement worker
    (without the fault plan: a planned crash must not loop forever).
    """

    n_workers: int = 2
    rpc_timeout_s: float = 300.0
    heartbeat_timeout_s: float = 120.0
    heartbeat_interval_s: float = 0.5
    max_recoveries: int = 3
    respawn: bool = False
    checkpoint_every: int = 1
    retry: RetryPolicy = RetryPolicy(max_attempts=3, base_delay=0.1)
    python: str | None = None  # interpreter for workers (None = sys.executable)
    env: dict[str, str] | None = None  # extra env for workers

    def __post_init__(self) -> None:
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1; got {self.n_workers}")
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1; got {self.checkpoint_every}")


@dataclasses.dataclass
class RpcLedger:
    """Per-op RPC totals on the coordinator: calls, seconds from request to
    decoded reply (``wall_s``), seconds inside the workers' handlers
    (``worker_s``; the difference is pipe, pickle and waiting), reply
    payload bytes, and the histogram bytes that crossed the pipes per tree
    depth."""

    calls: dict[str, int] = dataclasses.field(default_factory=dict)
    wall_s: dict[str, float] = dataclasses.field(default_factory=dict)
    worker_s: dict[str, float] = dataclasses.field(default_factory=dict)
    reply_bytes: dict[str, int] = dataclasses.field(default_factory=dict)
    hist_bytes_by_depth: dict[int, int] = dataclasses.field(default_factory=dict)

    def book(self, op: str, wall_s: float, worker_s: float, nbytes: int) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.wall_s[op] = self.wall_s.get(op, 0.0) + wall_s
        self.worker_s[op] = self.worker_s.get(op, 0.0) + worker_s
        self.reply_bytes[op] = self.reply_bytes.get(op, 0) + nbytes


# ----------------------------------------------------------------- shard prep
def prepare_shards(
    X: np.ndarray,
    y: np.ndarray,
    n_shards: int,
    root: str,
    *,
    max_bin: int = 256,
    page_bytes: int | None = None,
    device: str | torch.device = "cuda",
) -> list[str]:
    """Sketch once (shared cuts) and write one on-disk page cache per
    contiguous row shard, binned on ``device``; returns the shard cache dirs.

    Every shard is binned with the same `HistogramCuts` (sketched over the
    whole matrix, as `ArrayDMatrix` would), so the shards' histograms sum to
    what a single-process run over the concatenated rows builds. The caches
    are the reference's format: either package's `PagedDMatrix` reopens
    them.
    """
    from repro_torch.core.ellpack import DEFAULT_PAGE_BYTES
    from repro_torch.core.quantile import QuantileSketch
    from repro_torch.data.dmatrix import IterDMatrix

    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    sketch = QuantileSketch(X.shape[1], max_bin=min(max_bin, 255))
    sketch.update(X)
    cuts = sketch.finalize()
    bounds = np.linspace(0, X.shape[0], n_shards + 1).astype(int)
    dirs: list[str] = []
    for s in range(n_shards):
        d = os.path.join(root, f"shard_{s:04d}")
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        IterDMatrix(
            [(X[lo:hi], y[lo:hi])],
            max_bin=max_bin,
            cuts=cuts,
            cache_dir=d,
            page_bytes=page_bytes or DEFAULT_PAGE_BYTES,
            device=device,
        )
        dirs.append(d)
    return dirs


# ------------------------------------------------------------------- trainer
class ElasticTrainer:
    """Coordinator for elastic data-parallel training over shard dirs.

    Parameters
    ----------
    shard_dirs : on-disk page caches (one per shard, shared cuts — see
        `prepare_shards`); shard i starts on worker ``i % n_workers``.
    params : model hyperparameters. Gradient-based sampling is not supported
        elastically and raises.
    checkpoint_dir : where per-iteration checkpoints land (atomic
        `GradientBooster.save`; ``<dir>.prev`` keeps the last-good
        generation).
    config : `ElasticConfig`.
    fault_plan : optional `repro_torch.fault.FaultPlan` shipped to the
        *initial* workers via ``REPRO_FAULT_PLAN`` (chaos tests).
    device : where the coordinator evaluates splits and every worker builds
        its histograms; "cuda" (default) raises without a CUDA device, "cpu"
        runs the plain versions of the kernels.

    After `fit`, ``rpc`` holds the `RpcLedger`, ``worker_launches`` each
    worker's kernel launch counts as read at shutdown (workers that died
    have none), ``tree_seconds`` the host seconds of each tree built
    (checkpoint included) and ``recovery_seconds`` those of each recovery.
    """

    def __init__(
        self,
        shard_dirs: Sequence[str],
        params: BoosterParams,
        *,
        checkpoint_dir: str,
        config: ElasticConfig | None = None,
        fault_plan: fault_inject.FaultPlan | None = None,
        verbose: bool = False,
        device: str | torch.device = "cuda",
    ):
        if not shard_dirs:
            raise ValueError("need at least one shard dir")
        if sampling_requested(params.sampling):
            raise NotImplementedError(
                "ElasticTrainer does not support gradient-based sampling: the "
                "sampled path carries per-fit sampling state that checkpoint "
                "recovery cannot replay across shard reassignment. Use "
                "SamplingConfig(method='none') for elastic runs."
            )
        self.device = resolve_device(device)
        self.shard_dirs = list(shard_dirs)
        self.params = params
        self.cfg = config or ElasticConfig()
        self.checkpoint_dir = checkpoint_dir
        self.fault_plan = fault_plan
        self.verbose = verbose
        self.objective = obj_lib.get_objective(params.objective)
        self.stats = TransferStats()
        self.rpc = RpcLedger()
        self.worker_launches: dict[str, dict[str, int]] = {}
        self.tree_seconds: list[float] = []  # per tree built, in order
        self.recovery_seconds: list[float] = []  # per recovery
        self.recoveries = 0
        self.events: list[str] = []
        self._workers: list[WorkerHandle] = []
        self._owner: dict[int, WorkerHandle] = {}
        self._spawned = 0
        self._saved = False  # a checkpoint from THIS run exists on disk
        self._workdir = f"{checkpoint_dir}.workers"
        self.base_margin_: float | None = None
        self._hist_store = HistogramStore(
            enabled=params.hist_subtraction,
            transfer_stats=self.stats,
            retry=self.cfg.retry,
        )

        # shard 0's sidecar is the authoritative quantisation for the run
        # (prepare_shards wrote every shard with identical cuts)
        meta = np.load(os.path.join(self.shard_dirs[0], "dmatrix.npz"))
        self.cuts = HistogramCuts(
            values=meta["cut_values"],
            ptrs=meta["cut_ptrs"],
            min_vals=meta["cut_min_vals"],
        )
        self.n_bins = int(meta["n_bins"])
        self._bin_valid = bin_valid_from_cuts(self.cuts, self.n_bins, self.device)

    # ------------------------------------------------------------------ infra
    def _log(self, msg: str) -> None:
        self.events.append(msg)
        if self.verbose:
            print(f"[elastic] {msg}", file=sys.stderr)

    def _spawn_worker(self, *, with_faults: bool) -> WorkerHandle:
        env = dict(self.cfg.env or {})
        if with_faults and self.fault_plan is not None:
            env[fault_inject.ENV_VAR] = self.fault_plan.to_json()
        else:
            # replacements must not inherit the plan: a scripted crash that
            # respawned into the same crash would loop forever
            env[fault_inject.ENV_VAR] = ""
        name = f"w{self._spawned}"
        self._spawned += 1
        handle = WorkerHandle(
            name,
            self._workdir,
            python=self.cfg.python,
            env_extra=env,
            heartbeat_interval=self.cfg.heartbeat_interval_s,
        )
        meta = dataclasses.asdict(self.params)
        meta["sampling"] = dataclasses.asdict(self.params.sampling)
        self._request(handle, {"op": "init", "params": meta, "device": str(self.device)})
        self._log(f"spawned {name} (pid {handle.proc.pid})")
        return handle

    def _request(self, worker: WorkerHandle, msg: dict, *, retryable: bool = True) -> dict:
        """RPC with transient-error retry (idempotent ops only), booked in
        the `RpcLedger`."""
        t0 = time.perf_counter()
        if not retryable:
            reply = worker.request(msg, self.cfg.rpc_timeout_s)
        else:
            reply = self.cfg.retry.call(
                lambda: worker.request(msg, self.cfg.rpc_timeout_s),
                retryable=(TransientWorkerError,),
                stats=self.stats,
                describe=f"rpc {msg.get('op')} -> {worker.name}",
            )
        self.rpc.book(
            msg["op"], time.perf_counter() - t0, reply.get("op_s", 0.0), worker.last_reply_bytes
        )
        return reply

    def _assign(self, sid: int, worker: WorkerHandle) -> None:
        worker.shards.append(sid)
        self._owner[sid] = worker
        self._request(worker, {"op": "open_shard", "shard": sid, "dir": self.shard_dirs[sid]})

    def _check_workers(self) -> None:
        """Exit-code + heartbeat watchdog, run between iterations."""
        for w in self._workers:
            code = w.proc.poll()
            if code is not None:
                w.broken = True
                raise WorkerFailure(w.name, f"process exited with code {code}")
            age = w.heartbeat_age()
            if age > self.cfg.heartbeat_timeout_s:
                w.broken = True
                raise WorkerFailure(
                    w.name,
                    f"heartbeat stale for {age:.1f}s "
                    f"(timeout {self.cfg.heartbeat_timeout_s}s)",
                )

    # ------------------------------------------------------------------ setup
    def _start_workers(self) -> None:
        os.makedirs(self._workdir, exist_ok=True)
        self._workers = [
            self._spawn_worker(with_faults=True) for _ in range(self.cfg.n_workers)
        ]
        for sid in range(len(self.shard_dirs)):
            self._assign(sid, self._workers[sid % len(self._workers)])
        # base margin from aggregated per-shard label stats: both built-in
        # objectives' base scores are functions of the label mean (mean /
        # logit of clipped mean), so one synthetic-mean call is exact
        total, count = 0.0, 0
        for sid in sorted(self._owner):
            rep = self._request(self._owner[sid], {"op": "shard_stats", "shard": sid})
            total += rep["label_sum"]
            count += rep["label_count"]
        if self.params.base_score is not None:
            self.base_margin_ = float(self.params.base_score)
        else:
            mean = np.float32(total / max(count, 1))
            self.base_margin_ = float(
                self.objective.base_margin(np.full(1, mean, np.float32))
            )
        self._broadcast_margins(None)

    def _fresh_booster(self) -> GradientBooster:
        booster = GradientBooster(self.params, device=self.device)
        booster.cuts = self.cuts
        booster.base_margin_ = self.base_margin_
        booster.stats = self.stats
        return booster

    def _broadcast_margins(self, checkpoint: str | None) -> None:
        """Reset every worker's margins: from a checkpoint (resume replay) or
        to the flat base margin (fresh start)."""
        for w in self._workers:
            if checkpoint is None:
                self._request(w, {"op": "set_base_margin", "value": self.base_margin_})
            else:
                self._request(w, {"op": "reset", "checkpoint": checkpoint})

    # ------------------------------------------------------------------- fit
    def fit(self) -> GradientBooster:
        """Train to ``params.n_estimators`` trees, recovering worker deaths.

        Returns a fitted `GradientBooster` (trees + cuts + base margin) on
        the trainer's device; the final forest is also durably checkpointed
        at ``checkpoint_dir``.
        """
        p = self.params
        try:
            self._start_workers()  # computes base_margin_ before any booster
            booster = self._fresh_booster()
            while len(booster.trees) < p.n_estimators:
                it = len(booster.trees)
                t0 = time.perf_counter()
                try:
                    self._check_workers()
                    tree = self._build_tree(it)
                    booster.trees.append(tree)
                    self._finish_tree(tree)
                    if (it + 1) % self.cfg.checkpoint_every == 0 or (
                        it + 1 == p.n_estimators
                    ):
                        booster.save(self.checkpoint_dir)
                        self._saved = True
                    self.tree_seconds.append(time.perf_counter() - t0)
                except WorkerFailure as failure:
                    t0 = time.perf_counter()
                    while True:
                        try:
                            booster = self._recover(failure)
                            break
                        except WorkerFailure as another:
                            failure = another
                    self.recovery_seconds.append(time.perf_counter() - t0)
            return booster
        finally:
            self._shutdown()

    # ------------------------------------------------------------- tree build
    def _build_tree(self, iteration: int) -> TreeArrays:
        tp = self.params.tree_params()
        dev = self.device

        # begin_tree on every worker: gradients from the current margins,
        # positions zeroed; returns per-shard (sum_g, sum_h)
        shard_sums: dict[int, tuple[float, float]] = {}
        for w in self._workers:
            rep = self._request(w, {"op": "begin_tree", "iteration": iteration})
            for sid, (sg, sh) in rep["sums"].items():
                shard_sums[int(sid)] = (sg, sh)
        # f32 accumulation in shard-id order: the totals are independent of
        # which worker owns which shard, so recovery preserves them exactly
        total_g = np.float32(0.0)
        total_h = np.float32(0.0)
        for sid in sorted(shard_sums):
            total_g = np.float32(total_g + np.float32(shard_sums[sid][0]))
            total_h = np.float32(total_h + np.float32(shard_sums[sid][1]))

        def hist_fn(offset: int, count: int, plan) -> torch.Tensor:
            node_map = None if plan.node_map is None else plan.node_map.cpu().numpy()
            depth = (offset + 1).bit_length() - 1  # of the window's first node
            total: np.ndarray | None = None
            for sid in sorted(self._owner):
                rep = self._request(
                    self._owner[sid],
                    {
                        "op": "hist",
                        "shard": sid,
                        "offset": offset,
                        "count": plan.count,
                        "n_build": plan.n_build,
                        "node_map": node_map,
                    },
                )
                part = rep["hist"]
                by_depth = self.rpc.hist_bytes_by_depth
                by_depth[depth] = by_depth.get(depth, 0) + part.nbytes
                total = part if total is None else total + part
            return torch.from_numpy(total).to(dev)

        def partition_fn(feature, split_bin, default_left, is_leaf, count_level):
            msg = {
                "op": "partition",
                "feature": feature.cpu().numpy(),
                "split_bin": split_bin.cpu().numpy(),
                "default_left": default_left.cpu().numpy(),
                "is_leaf": is_leaf.cpu().numpy(),
                "count_window": count_level,
            }
            counts: np.ndarray | None = None
            for sid in sorted(self._owner):
                rep = self._request(self._owner[sid], dict(msg, shard=sid))
                c = rep["counts"]
                if c is not None:
                    counts = c if counts is None else counts + c
            return None if counts is None else torch.from_numpy(counts).to(dev)

        return tree_growth_driver(tp)(
            hist_fn,
            partition_fn,
            torch.tensor(total_g, dtype=torch.float32, device=dev),
            torch.tensor(total_h, dtype=torch.float32, device=dev),
            self.n_bins,
            self._bin_valid,
            tp,
            cut_values=self.cuts.values,
            cut_ptrs=self.cuts.ptrs,
            hist_cache=self._hist_store,
        )

    def _finish_tree(self, tree: TreeArrays) -> None:
        arrays = {f: getattr(tree, f).cpu().numpy() for f in TreeArrays._fields}
        for w in self._workers:
            # NOT retryable: margins += leaf is cumulative, a double-apply
            # would corrupt them. Failure here falls through to recovery,
            # which rebuilds margins from the checkpoint.
            self._request(
                w,
                {"op": "finish_tree", "tree": arrays, "learning_rate": self.params.learning_rate},
                retryable=False,
            )

    # --------------------------------------------------------------- recovery
    def _recover(self, failure: WorkerFailure) -> GradientBooster:
        self.recoveries += 1
        if self.recoveries > self.cfg.max_recoveries:
            raise ElasticError(
                f"giving up after {self.cfg.max_recoveries} recoveries "
                f"(last failure — {failure})"
            ) from failure
        self._log(f"recovering from failure: {failure}")

        dead = [w for w in self._workers if w.broken or w.proc.poll() is not None]
        for w in dead:
            self._log(f"terminating dead worker {w.name}")
            w.terminate()
            self._workers.remove(w)
        orphans = sorted(sid for sid, w in self._owner.items() if w not in self._workers)

        if self.cfg.respawn or not self._workers:
            for _ in range(max(len(dead), 1) if not self._workers else len(dead)):
                self._workers.append(self._spawn_worker(with_faults=False))
        for sid in orphans:
            target = min(self._workers, key=lambda w: len(w.shards))
            self._log(f"re-assigning shard {sid} -> {target.name}")
            self._assign(sid, target)

        # reload the forest from the last durable checkpoint (falling back to
        # <dir>.prev if the newest generation is damaged), then reset every
        # worker's margins from it — survivors included, so margins always
        # correspond exactly to the restored forest
        ckpt = (
            GradientBooster.last_good_checkpoint(self.checkpoint_dir)
            if self._saved
            else None
        )
        if ckpt is None:
            self._log("no durable checkpoint yet: restarting forest from scratch")
            booster = self._fresh_booster()
            self._broadcast_margins(None)
        else:
            booster = GradientBooster.load(ckpt, device=self.device)
            booster.stats = self.stats
            self._log(f"resumed {len(booster.trees)} trees from {ckpt}")
            self._broadcast_margins(ckpt)
        return booster

    # --------------------------------------------------------------- shutdown
    def _shutdown(self) -> None:
        for w in self._workers:
            try:
                if w.alive():
                    rep = w.request({"op": "shutdown"}, timeout=5.0)
                    self.worker_launches[w.name] = rep.get("launches", {})
            except ElasticError:
                pass
            w.terminate()
        self._workers = []
        self._owner = {}
        shutil.rmtree(self._workdir, ignore_errors=True)
