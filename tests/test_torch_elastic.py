"""The port's elastic trainer (`repro_torch.distributed`) against the
reference's, on the CPU, with real subprocess workers (``device="cpu"``:
the workers run the kernels' plain versions).

Both packages train on the SAME shard directories (the page format is
shared), at the reference chaos tests' size: 600 x 8, max_bin 32, depth 3,
two shards of 4 KiB pages. The equality bar is two-tiered, as there:

  * port vs port (chaos vs uninterrupted, resumed vs uninterrupted) is bit
    for bit: per-shard sums, histograms and counts are accumulated in
    sorted shard order, and resumed margins replay the incremental
    arithmetic;
  * port vs reference uses the structural oracle `assert_forests_equal`
    (the two packages sum histograms and sigmoids in another f32 order);
    margins replayed from one checkpoint are equal bit for bit.

Every trainer run is module-scoped: each spawns two worker processes that
import torch.
"""
import os

import numpy as np
import pytest
import torch
from oracle import assert_forests_equal

from repro.core.booster import GradientBooster as JBooster
from repro.data.dmatrix import PagedDMatrix as JPagedDMatrix
from repro.distributed import ElasticConfig as JElasticConfig
from repro.distributed import ElasticTrainer as JElasticTrainer
from repro.distributed import prepare_shards as j_prepare_shards
from repro_torch.core.booster import BoosterParams, GradientBooster
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.sampling import SamplingConfig
from repro_torch.data.dmatrix import IterDMatrix, PagedDMatrix
from repro_torch.data.synthetic import make_classification
from repro_torch.distributed import (
    ElasticConfig,
    ElasticTrainer,
    prepare_shards,
)
from repro_torch.distributed.elastic import recv_msg_blocking, recv_msg_deadline, send_msg
from repro_torch.fault import FaultPlan, FaultSpec

PARAMS = dict(n_estimators=4, max_depth=3, max_bin=32, objective="binary:logistic")
# one thread per worker: six test processes run beside them
CFG = ElasticConfig(
    n_workers=2, rpc_timeout_s=180.0, heartbeat_timeout_s=120.0, env={"OMP_NUM_THREADS": "1"}
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dataset():
    return make_classification(600, 8, class_sep=1.5, flip_y=0.02, seed=11)


@pytest.fixture(scope="module")
def shards(dataset, tmp_path_factory):
    X, y = dataset
    root = tmp_path_factory.mktemp("elastic") / "shards"
    return prepare_shards(X, y, 2, str(root), max_bin=32, page_bytes=4096, device="cpu")


@pytest.fixture(scope="module")
def smooth(shards, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("smooth") / "ckpt")
    tr = ElasticTrainer(shards, BoosterParams(seed=0, **PARAMS), checkpoint_dir=ckpt,
                        config=CFG, device="cpu")
    return tr, tr.fit(), ckpt


@pytest.fixture(scope="module")
def chaos(shards, tmp_path_factory):
    plan = FaultPlan.of(
        FaultSpec(site="elastic.worker.iteration", at=3, action="kill", match={"worker": "w1"})
    )
    ckpt = str(tmp_path_factory.mktemp("chaos") / "ckpt")
    tr = ElasticTrainer(shards, BoosterParams(seed=0, **PARAMS), checkpoint_dir=ckpt,
                        config=CFG, fault_plan=plan, device="cpu")
    return tr, tr.fit()


@pytest.fixture(scope="module")
def reference(shards, tmp_path_factory):
    """The reference's elastic trainer on the port's shard directories."""
    from repro.core.booster import BoosterParams as JParams

    ckpt = str(tmp_path_factory.mktemp("reference") / "ckpt")
    cfg = JElasticConfig(n_workers=2, rpc_timeout_s=180.0, heartbeat_timeout_s=120.0)
    tr = JElasticTrainer(shards, JParams(seed=0, **PARAMS), checkpoint_dir=ckpt, config=cfg)
    return tr.fit(), ckpt


def _assert_identical(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for field in a._fields:
            assert torch.equal(getattr(a, field), getattr(b, field)), f"tree {i} {field}"


def test_prepare_shards_pages_equal_reference(dataset, shards, tmp_path):
    X, y = dataset
    ref_dirs = j_prepare_shards(X, y, 2, str(tmp_path / "ref"), max_bin=32, page_bytes=4096)
    assert len(ref_dirs) == len(shards) == 2
    for port_dir, ref_dir in zip(shards, ref_dirs):
        port, ref = PagedDMatrix(port_dir), JPagedDMatrix(ref_dir)
        for f in ("values", "ptrs", "min_vals"):
            np.testing.assert_array_equal(getattr(port.cuts, f), getattr(ref.cuts, f))
        np.testing.assert_array_equal(port.labels, ref.labels)
        assert port.n_bins == ref.n_bins and port.n_rows == ref.n_rows == 300
        ps, js = port.page_set(), ref.page_set()
        assert ps.page_extents == js.page_extents
        for (_, a), (_, b) in zip(ps.iter_pages(), js.iter_pages()):
            np.testing.assert_array_equal(a.bins, b.bins)


def test_elastic_forest_matches_reference_elastic(smooth, reference):
    tr, booster, ckpt = smooth
    ref_booster, _ = reference
    assert len(booster.trees) == PARAMS["n_estimators"] and tr.recoveries == 0
    assert booster.base_margin_ == ref_booster.base_margin_
    assert_forests_equal(booster.trees, ref_booster.trees)
    # every iteration checkpointed; the final one loads in both packages
    GradientBooster.verify_checkpoint(ckpt)
    _assert_identical(GradientBooster.load(ckpt, device="cpu").trees, booster.trees)
    assert_forests_equal(JBooster.load(ckpt).trees, booster.trees, exact=True,
                         leaf_rtol=0, leaf_atol=0)


def test_elastic_rpc_ledger_and_worker_counters(smooth):
    """The coordinator books every op; the histogram bytes per depth are the
    build slots' histograms of both shards over every tree; the workers'
    launch counters come back at shutdown (all zero on the CPU, where no
    kernel launches)."""
    tr, _, _ = smooth
    n_trees, depth = PARAMS["n_estimators"], PARAMS["max_depth"]
    assert tr.rpc.calls["hist"] == tr.rpc.calls["partition"] == 2 * n_trees * depth
    assert tr.rpc.calls["finish_tree"] == 2 * n_trees
    one = 8 * 32 * 2 * 4  # one node's (m, n_bins, 2) f32 histogram
    slots = {0: 1, 1: 1, 2: 2}  # full root build, then the smaller child of each pair
    assert tr.rpc.hist_bytes_by_depth == {d: 2 * n_trees * slots[d] * one for d in range(depth)}
    assert all(tr.rpc.wall_s[op] >= tr.rpc.worker_s[op] > 0 for op in ("hist", "partition"))
    assert sorted(tr.worker_launches) == ["w0", "w1"]
    for counts in tr.worker_launches.values():
        assert set(counts) >= {"build_histogram", "build_histogram_nodes", "partition_rows"}
        assert not any(counts.values())


def test_chaos_worker_kill_recovers_bit_for_bit(smooth, chaos):
    """Kill w1 at iteration 3: the coordinator detects the death, re-assigns
    its shard, resumes from the last checkpoint, and the recovered forest
    equals the uninterrupted run exactly."""
    _, want, _ = smooth
    tr, got = chaos
    assert tr.recoveries == 1
    assert any("re-assigning shard 1 -> w0" in e for e in tr.events)
    assert any("resumed 2 trees" in e for e in tr.events)
    _assert_identical(got.trees, want.trees)


def test_elastic_matches_single_process_streaming(smooth, dataset):
    """The elastic forest against the port's single-process streaming fit on
    the same rows and cuts (structural oracle: per-shard f32 sums differ from
    the single stream's)."""
    X, y = dataset
    _, booster, _ = smooth
    single = GradientBooster(BoosterParams(seed=0, **PARAMS), device="cpu",
                             policy=ExecutionPolicy(mode="out_of_core"))
    single.fit(IterDMatrix([(X, y)], max_bin=32, cuts=booster.cuts, page_bytes=4096,
                           device="cpu"))
    assert_forests_equal(booster.trees, single.trees)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_margins_equal_reference(smooth, reference, shards, writer):
    """Both packages replay one checkpoint's margins over one page cache to
    the same bits."""
    ckpt = reference[1] if writer == "reference" else smooth[2]
    port = GradientBooster.resume(ckpt, PagedDMatrix(shards[1]), device="cpu")
    ref = JBooster.resume(ckpt, JPagedDMatrix(shards[1]))
    assert len(port.trees) == len(ref.trees) == PARAMS["n_estimators"]
    assert port.margins_.dtype == torch.float32
    np.testing.assert_array_equal(port.margins_.numpy(), ref.margins_)


def test_streaming_resume_equals_uninterrupted(shards, tmp_path):
    """The single-process crash/resume path: a fit checkpointed after 2 trees,
    resumed and boosted on with ``start_iteration=2``, grows the trees and
    margins of the uninterrupted fit, bit for bit."""
    params = BoosterParams(seed=0, **PARAMS)
    full = GradientBooster(params, device="cpu", policy=ExecutionPolicy(mode="out_of_core"))
    full.fit(PagedDMatrix(shards[0]))
    ckpt = str(tmp_path / "ckpt")
    part = GradientBooster(
        BoosterParams(seed=0, **dict(PARAMS, n_estimators=2)), device="cpu",
        policy=ExecutionPolicy(mode="out_of_core", checkpoint_every=1, checkpoint_dir=ckpt),
    )
    part.fit(PagedDMatrix(shards[0]))
    resumed = GradientBooster.resume(ckpt, PagedDMatrix(shards[0]), device="cpu")
    assert torch.equal(resumed.margins_, part.margins_)
    resumed.params = params  # on to the full horizon
    with pytest.raises(ValueError, match="start_iteration"):
        resumed.fit(PagedDMatrix(shards[0]), start_iteration=1)
    resumed.fit(PagedDMatrix(shards[0]), start_iteration=2)
    _assert_identical(resumed.trees, full.trees)
    assert torch.equal(resumed.margins_, full.margins_)


def test_resume_rejects_other_cuts(smooth, dataset, tmp_path):
    X, y = dataset
    _, _, ckpt = smooth
    other = IterDMatrix([(X[:300] * 2.0, y[:300])], max_bin=32, device="cpu",
                        cache_dir=str(tmp_path / "other"), page_bytes=4096)
    with pytest.raises(ValueError, match="cuts"):
        GradientBooster.resume(ckpt, other, device="cpu")


def test_trainer_rejects_sampling_and_bad_config(shards, tmp_path):
    with pytest.raises(NotImplementedError, match="sampling"):
        ElasticTrainer(shards, BoosterParams(sampling=SamplingConfig(method="mvs", f=0.5)),
                       checkpoint_dir=str(tmp_path / "c"), device="cpu")
    with pytest.raises(ValueError, match="n_workers"):
        ElasticConfig(n_workers=0)
    with pytest.raises(ValueError, match="checkpoint_every"):
        ElasticConfig(checkpoint_every=0)
    with pytest.raises(ValueError, match="shard"):
        ElasticTrainer([], BoosterParams(), checkpoint_dir=str(tmp_path / "c"), device="cpu")


def test_frames_round_trip_over_a_pipe():
    r, w = os.pipe()
    try:
        msg = {"op": "hist", "hist": np.arange(6, dtype=np.float32).reshape(2, 3)}
        send_msg(w, msg)
        send_msg(w, {"op": "ping"})
        got, nbytes = recv_msg_deadline(r, deadline=float("inf"))
        assert nbytes > 24 and got["op"] == "hist"
        np.testing.assert_array_equal(got["hist"], msg["hist"])
        os.close(w)
        w = None
        with os.fdopen(r, "rb") as fh:
            r = None
            assert recv_msg_blocking(fh) == {"op": "ping"}
            assert recv_msg_blocking(fh) is None  # clean EOF
    finally:
        for fd in (r, w):
            if fd is not None:
                os.close(fd)
