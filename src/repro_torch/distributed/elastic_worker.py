"""Subprocess entry point for `ElasticTrainer` workers.

``python -m repro_torch.distributed.elastic_worker --name w0 --heartbeat <path>``

Counterpart of `repro.distributed.elastic_worker`. One worker owns a set of
on-disk shards (`PagedDMatrix` page caches) and serves the coordinator's
per-tree RPCs over stdin/stdout, on the device the ``init`` message names:

  init            hyperparameters (BoosterParams dict) and the device
  open_shard      reopen one shard's page cache
  shard_stats     per-shard (label_sum, label_count) for the base margin
  set_base_margin flat margins (fresh start)
  reset           reload margins from a checkpoint via GradientBooster.resume
                  (the recovery primitive: replayed margins are bit for bit
                  the incremental ones)
  begin_tree      gradients from current margins + zeroed positions;
                  returns per-shard (sum_g, sum_h)
  hist            one streamed histogram pass over a node window: the
                  level-window kernel (kernel 4) once per page
  partition       re-route rows by the broadcast split arrays (the partition
                  kernel once per page); optional per-node row counts for
                  the subtraction planner
  finish_tree     apply the finished tree's leaves to the margins
  ping/shutdown   liveness / clean exit; both replies carry the worker's
                  kernel launch counts

Every reply carries ``op_s``, the seconds the handler took (the histogram's
copy back to the host included), so the coordinator can tell the pipe's
time from the work's.

Margins live in host numpy f32 and are updated with the reference's
expression (``margins[page] += lr * leaf[pos]``), the one `resume` replays.

Protocol hygiene: the binary framing owns the *original* stdout fd (dup'd at
startup); fd 1 is then redirected to stderr so stray library prints can never
corrupt a frame. A heartbeat thread touches ``--heartbeat`` every
``--heartbeat-interval`` seconds — started before the handler loop so the
coordinator's staleness watchdog sees a live file even while an op runs long.

Fault injection: `repro_torch.fault.install_from_env` arms any plan the
coordinator serialized into ``REPRO_FAULT_PLAN``; the worker fires
"elastic.rpc" (worker/op context) before each op and
"elastic.worker.iteration" (worker/iteration context) at each begin_tree —
the latter is where the chaos test's "kill worker w1 at iteration k" lands
(``os._exit``, a real crash).
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
import traceback

from repro_torch.fault import inject as fault_inject
from repro_torch.kernels import launch_counts


def _start_heartbeat(path: str, interval: float) -> None:
    def beat() -> None:
        while True:
            try:
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as fh:
                    fh.write(str(time.time()))
                os.replace(tmp, path)
            except OSError:  # pragma: no cover - transient fs hiccup
                pass
            time.sleep(interval)

    threading.Thread(target=beat, daemon=True, name="heartbeat").start()


class _Shard:
    """One opened shard: its page cache plus per-tree training state."""

    def __init__(self, dm, device):
        import numpy as np
        import torch

        self.dm = dm
        self.pages = dm.page_set()
        self.labels_np = np.asarray(dm.require_labels(), np.float32)
        self.labels = torch.from_numpy(self.labels_np).to(device)
        self.margins: "np.ndarray | None" = None
        self.g = None
        self.h = None
        self.positions: dict = {}


class _WorkerState:
    def __init__(self, name: str):
        self.name = name
        self.params = None
        self.objective = None
        self.device = None
        self.shards: dict[int, _Shard] = {}

    # ------------------------------------------------------------------ ops
    def handle(self, msg: dict) -> dict:
        op = msg["op"]
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        return fn(msg)

    def _stream(self, sh: _Shard):
        return sh.pages.stream(device=self.device)

    def _op_init(self, msg: dict) -> dict:
        from repro_torch.core import objectives as obj_lib
        from repro_torch.core.booster import BoosterParams, resolve_device
        from repro_torch.core.sampling import SamplingConfig

        meta = dict(msg["params"])
        sampling = SamplingConfig(**meta.pop("sampling"))
        self.params = BoosterParams(sampling=sampling, **meta)
        self.objective = obj_lib.get_objective(self.params.objective)
        self.device = resolve_device(msg["device"])
        return {}

    def _op_open_shard(self, msg: dict) -> dict:
        from repro_torch.data.dmatrix import PagedDMatrix

        sid = int(msg["shard"])
        if sid not in self.shards:  # idempotent under RPC retry
            self.shards[sid] = _Shard(PagedDMatrix(msg["dir"]), self.device)
        return {"n_rows": int(self.shards[sid].dm.n_rows)}

    def _op_shard_stats(self, msg: dict) -> dict:
        import numpy as np

        sh = self.shards[int(msg["shard"])]
        return {
            # float64 accumulation: the per-shard sum must not depend on
            # shard size, so the coordinator's aggregated mean is stable
            "label_sum": float(np.sum(sh.labels_np, dtype=np.float64)),
            "label_count": int(sh.labels_np.shape[0]),
        }

    def _op_set_base_margin(self, msg: dict) -> dict:
        import numpy as np

        value = float(msg["value"])
        for sh in self.shards.values():
            sh.margins = np.full(sh.dm.n_rows, value, np.float32)
            sh.g = sh.h = None
            sh.positions = {}
        return {}

    def _op_reset(self, msg: dict) -> dict:
        from repro_torch.core.booster import GradientBooster

        n_trees = 0
        for sh in self.shards.values():
            booster = GradientBooster.resume(msg["checkpoint"], sh.dm, device=self.device)
            sh.margins = booster.margins_.cpu().numpy()
            sh.g = sh.h = None
            sh.positions = {}
            n_trees = len(booster.trees)
        return {"n_trees": n_trees}

    def _op_begin_tree(self, msg: dict) -> dict:
        import torch

        fault_inject.fire(
            "elastic.worker.iteration",
            worker=self.name,
            iteration=int(msg["iteration"]),
        )
        sums: dict[int, tuple[float, float]] = {}
        for sid, sh in self.shards.items():
            if sh.margins is None:
                raise RuntimeError("begin_tree before set_base_margin/reset")
            margins = torch.from_numpy(sh.margins).to(self.device)
            sh.g, sh.h = self.objective.grad_hess(margins, sh.labels)
            sh.positions = {
                i: torch.zeros(nr, dtype=torch.int32, device=self.device)
                for i, (_ro, nr) in enumerate(sh.pages.page_extents)
            }
            sums[sid] = (float(sh.g.sum()), float(sh.h.sum()))
        return {"sums": sums}

    def _op_hist(self, msg: dict) -> dict:
        import torch

        from repro_torch.kernels import ops

        sh = self.shards[int(msg["shard"])]
        node_map = msg["node_map"]
        hist = ops.build_histogram_paged(
            self._stream(sh),
            sh.g,
            sh.h,
            sh.positions,
            int(msg["offset"]),
            int(msg["n_build"]),
            sh.dm.n_bins,
            node_map=None if node_map is None else torch.from_numpy(node_map).to(self.device),
        )
        return {"hist": hist.cpu().numpy()}

    def _op_partition(self, msg: dict) -> dict:
        import torch

        from repro_torch.core.histcache import new_level_counts
        from repro_torch.kernels import ops

        sh = self.shards[int(msg["shard"])]
        split = [
            torch.from_numpy(msg[k]).to(self.device)
            for k in ("feature", "split_bin", "default_left", "is_leaf")
        ]
        window = msg["count_window"]
        window = None if window is None else (int(window[0]), int(window[1]))
        # one launch per page; every page adds its rows into the same counts
        counts = new_level_counts(window, self.device)
        for sp in self._stream(sh):
            sh.positions[sp.index] = ops.partition_rows(
                sp.device, sh.positions[sp.index], *split, window, counts
            )
        return {"counts": None if counts is None else counts.cpu().numpy()}

    def _op_finish_tree(self, msg: dict) -> dict:
        import numpy as np

        leaf = np.asarray(msg["tree"]["leaf_value"])
        lr = float(msg["learning_rate"])
        for sh in self.shards.values():
            # the reference's arithmetic, which GradientBooster.resume
            # replays: f32 leaf values times lr in f32, added in f32 — so a
            # checkpoint-reset worker reproduces these margins bit for bit
            for i, (ro, nr) in enumerate(sh.pages.page_extents):
                pos = sh.positions[i].cpu().numpy()
                sh.margins[ro : ro + nr] += lr * leaf[pos]
            sh.g = sh.h = None
            sh.positions = {}
        return {}

    def _op_ping(self, msg: dict) -> dict:
        return {"name": self.name, "launches": launch_counts()}

    def _op_shutdown(self, msg: dict) -> dict:
        return {"launches": launch_counts()}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--name", required=True)
    parser.add_argument("--heartbeat", required=True)
    parser.add_argument("--heartbeat-interval", type=float, default=0.5)
    args = parser.parse_args(argv)

    _start_heartbeat(args.heartbeat, args.heartbeat_interval)
    fault_inject.install_from_env()

    # the frame protocol owns the original stdout; stray prints go to stderr
    out_fd = os.dup(sys.stdout.fileno())
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    in_fh = os.fdopen(os.dup(sys.stdin.fileno()), "rb")

    from repro_torch.distributed.elastic import recv_msg_blocking, send_msg

    state = _WorkerState(args.name)
    while True:
        msg = recv_msg_blocking(in_fh)
        if msg is None:  # coordinator closed the pipe
            break
        op = msg.get("op", "")
        t0 = time.perf_counter()
        try:
            fault_inject.fire("elastic.rpc", worker=args.name, op=op)
            reply = state.handle(msg)
        except Exception as err:
            reply = {
                "error": f"{type(err).__name__}: {err}",
                "transient": isinstance(err, (OSError, TimeoutError, ConnectionError)),
                "traceback": traceback.format_exc(),
            }
        reply["op_s"] = time.perf_counter() - t0
        reply["req_id"] = msg.get("req_id")
        send_msg(out_fd, reply)
        if op == "shutdown":
            break


if __name__ == "__main__":
    main()
