"""The sharded trainer (`repro_torch.distributed.gbdt_shard`) against the
reference, on the CPU.

A world of one runs in this process, with no process group, against the
reference's `grow_tree_distributed` on a 1-device mesh: depthwise, on the
bf16 wire, 1 x 1 feature-parallel, and lossguide under a 2,048-byte
histogram budget with ``retained_levels=2`` (trees and positions under
`assert_trees_equal`). Four gloo ranks run once per module
(`torch_shard_ranks.run`, one `torch.multiprocessing` spawn, a ``file://``
store under the test's tmp dir and a 60 s collective timeout), beside the
reference on a 4-device host mesh in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``):

  data-parallel and 2 x 2       ``feature``, ``split_bin`` and positions
                                equal, leaves within 1e-5 (the reference's
                                bounds, `test_distributed.py`)
  bf16 wire                     over 95% of features agree with the f32 tree
  lossguide, 16 leaves          `assert_trees_equal`, positions equal

The paths whose reference is red on this host (its `fit_sharded` and paged
build raise a `ShardingTypeError` under jax 0.9) are held against the
reference's in-core builders, as its red tests pin them: the paged build
against `grow_tree`, `fit_sharded` on an `IterDMatrix` against
``GradientBooster(policy=ExecutionPolicy(mode="in_core")).fit``. Within the
port: bitpack staging bit for bit the raw fit, an f16 wire close to it (the
reference's bounds), a requested MVS sample drawn over all rows (the
sharded forest equals the port's in-core one), the spill ledger, three
`make_gbdt_step_fn` steps lowering the logloss, and the validation errors.
A rank that dies makes the others' next collective raise.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from oracle import assert_forests_equal, assert_trees_equal

import torch_shard_ranks as ranks
from repro.core.booster import BoosterParams as JBoosterParams
from repro.core.booster import GradientBooster as JBooster
from repro.core.booster import bin_valid_from_cuts as j_bin_valid
from repro.core.ellpack import create_ellpack_inmemory as j_create
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.core.tree import TreeParams as JTreeParams
from repro.core.tree import grow_tree as j_grow_tree
from repro.data.dmatrix import IterDMatrix as JIterDMatrix
from repro.distributed import DistConfig as JDistConfig
from repro.distributed import grow_tree_distributed as j_grow_tree_distributed
from repro_torch.core.booster import BoosterParams, bin_valid_from_cuts
from repro_torch.core.ellpack import create_ellpack_inmemory
from repro_torch.core.tree import TreeArrays, TreeParams
from repro_torch.data.dmatrix import IterDMatrix
from repro_torch.data.pages import TransferStats
from repro_torch.distributed import (
    DistConfig,
    check_feature_parallel_lossguide,
    fit_sharded,
    grow_tree_distributed,
    make_gbdt_step_fn,
    make_mesh,
)

CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPAWN_DEADLINE_S = 240  # the ranks and the reference subprocess, together

REF4_SCRIPT = r"""
import sys
import jax, numpy as np, jax.numpy as jnp
from repro.core.booster import bin_valid_from_cuts
from repro.core.ellpack import create_ellpack_inmemory
from repro.core.tree import TreeParams
from repro.distributed import DistConfig, grow_tree_distributed
from repro.data.synthetic import make_classification

assert len(jax.devices()) == 4, jax.devices()
X, y = make_classification(1024, 16, seed=1)
ell = create_ellpack_inmemory(X, max_bin=16)
bins = jnp.asarray(ell.single_page().bins.astype(np.int32))
rng = np.random.default_rng(0)
g = jnp.asarray(rng.normal(size=1024).astype(np.float32))
h = jnp.ones(1024, jnp.float32)
bv = bin_valid_from_cuts(ell.cuts, 16)
tp = TreeParams(max_depth=4)
mesh = jax.make_mesh((4,), ("data",))
mesh2 = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for case, m, cfg in (("dp", mesh, DistConfig()), ("fp", mesh2, DistConfig(feature_axis="model")),
                     ("lg", mesh, DistConfig(grow_policy="lossguide", max_leaves=16))):
    tree, pos = grow_tree_distributed(m, bins, g, h, 16, bv, tp, cfg, ell.cuts.values, ell.cuts.ptrs)
    for f in tree._fields:
        out[f"{case}_tree_{f}"] = np.asarray(getattr(tree, f))
    out[f"{case}_positions"] = np.asarray(pos)
np.savez(sys.argv[1], **out)
print("REF4_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ inputs
class Problem:
    """`test_distributed.py`'s inputs in both packages' in-core forms."""

    def __init__(self):
        X, self.y, g, h = ranks.inputs()
        self.g_np, self.h_np = g, h
        self.jell = j_create(X, max_bin=ranks.MAX_BIN)
        self.ell = create_ellpack_inmemory(X, max_bin=ranks.MAX_BIN, device=CPU)
        self.bins = self.ell.single_page().bins
        np.testing.assert_array_equal(self.bins, self.jell.single_page().bins)
        self.jbins = jnp.asarray(self.bins.astype(np.int32))
        self.jbv = j_bin_valid(self.jell.cuts, ranks.MAX_BIN)
        self.bv = bin_valid_from_cuts(self.ell.cuts, ranks.MAX_BIN, CPU)
        self.g, self.h = torch.from_numpy(g), torch.from_numpy(h)

    def ref_in_core(self, tp: JTreeParams):
        return j_grow_tree(
            self.jbins, jnp.asarray(self.g_np), jnp.asarray(self.h_np), ranks.MAX_BIN,
            self.jbv, tp, self.jell.cuts.values, self.jell.cuts.ptrs,
        )


@pytest.fixture(scope="module")
def prob():
    return Problem()


def _tree(npz, prefix: str = "tree_") -> TreeArrays:
    return TreeArrays(*[npz[f"{prefix}{f}"] for f in TreeArrays._fields])


def _forest(npz) -> list[TreeArrays]:
    stacked = [npz[f"forest_{f}"] for f in TreeArrays._fields]
    return [TreeArrays(*[a[i] for a in stacked]) for i in range(stacked[0].shape[0])]


def _assert_same_tree(got, want) -> None:
    for f in TreeArrays._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


# --------------------------------------------------- four ranks, spawned once
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Runs `torch_shard_ranks.run` on 4 gloo ranks and the reference on a
    4-device host mesh, concurrently; returns their output directory."""
    out = tmp_path_factory.mktemp("shard")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(p for p in (SRC, env.get("PYTHONPATH", "")) if p)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF4_SCRIPT, str(out / "ref4.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    ctx = mp.start_processes(
        ranks.run, args=(str(out / "store"), str(out)), nprocs=ranks.WORLD, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        for proc in ctx.processes:
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
        ref_out, _ = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p.pid for p in ctx.processes if p.is_alive()]
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        if ref.poll() is None:
            ref.kill()
    assert not hung, f"ranks {hung} still running after {SPAWN_DEADLINE_S} s"
    codes = [p.exitcode for p in ctx.processes]
    # the last rank dies on purpose (os._exit(3)); the others exit 4 after
    # recording what their collective raised
    assert codes == [4] * (ranks.WORLD - 1) + [3], f"rank exit codes {codes}"
    assert ref.returncode == 0 and "REF4_OK" in ref_out, ref_out
    return out


def _rank_results(out, case: str) -> list:
    return [np.load(out / f"{case}_r{r}.npz") for r in range(ranks.WORLD)]


@pytest.mark.parametrize("case", ["dp", "fp", "bf16", "lg", "paged", "paged_lg", "fit_raw"])
def test_every_rank_returns_the_same_tree(spawned, case):
    res = _rank_results(spawned, case)
    for other in res[1:]:
        for key in res[0].files:
            np.testing.assert_array_equal(other[key], res[0][key], err_msg=f"{case}: {key}")


@pytest.mark.parametrize("case", ["dp", "fp"])
def test_four_ranks_match_reference_mesh(spawned, case):
    got = np.load(spawned / f"{case}_r0.npz")
    want = np.load(spawned / "ref4.npz")
    np.testing.assert_array_equal(got["tree_feature"], want[f"{case}_tree_feature"])
    np.testing.assert_array_equal(got["tree_split_bin"], want[f"{case}_tree_split_bin"])
    np.testing.assert_array_equal(got["positions"], want[f"{case}_positions"])
    assert np.abs(got["tree_leaf_value"] - want[f"{case}_tree_leaf_value"]).max() < 1e-5


def test_four_ranks_bf16_wire_keeps_splits(spawned, prob):
    got = np.load(spawned / "bf16_r0.npz")
    want = prob.ref_in_core(JTreeParams(max_depth=ranks.DEPTH))
    assert np.mean(got["tree_feature"] == np.asarray(want.tree.feature)) > 0.95


def test_four_ranks_lossguide_matches_reference_mesh(spawned):
    got = np.load(spawned / "lg_r0.npz")
    want = np.load(spawned / "ref4.npz")
    assert_trees_equal(_tree(got), _tree(want, "lg_tree_"),
                       got_positions=got["positions"], want_positions=want["lg_positions"])


@pytest.mark.parametrize("case,policy", [("paged", "depthwise"), ("paged_lg", "lossguide")])
def test_four_ranks_paged_matches_reference_in_core(spawned, prob, case, policy):
    got = np.load(spawned / f"{case}_r0.npz")
    want = prob.ref_in_core(JTreeParams(max_depth=ranks.DEPTH, grow_policy=policy, max_leaves=16))
    assert_trees_equal(_tree(got), want.tree, got_positions=got["positions"],
                       want_positions=np.asarray(want.positions))


@pytest.fixture(scope="module")
def ref_fit():
    """The reference's in-core fit of the sharded front-door inputs."""
    X, y = ranks.fit_inputs()
    dm = JIterDMatrix([(X[:600], y[:600]), (X[600:], y[600:])], max_bin=16)
    b = JBooster(JBoosterParams(**ranks.FIT_PARAMS), policy=JPolicy(mode="in_core")).fit(dm)
    return b, np.asarray(b.predict_margin(X))


def test_four_ranks_fit_sharded_matches_reference_in_core(spawned, ref_fit):
    got = np.load(spawned / "fit_raw_r0.npz")
    assert_forests_equal(_forest(got), ref_fit[0].trees)
    np.testing.assert_allclose(got["margin"], ref_fit[1], rtol=1e-4, atol=1e-5)


def test_world_of_one_fit_sharded_matches_reference_in_core(ref_fit):
    X, y = ranks.fit_inputs()
    dm = IterDMatrix([(X[:600], y[:600]), (X[600:], y[600:])], max_bin=16, device=CPU)
    b = fit_sharded(make_mesh((1,), ("data",), device="cpu"), dm,
                    params=BoosterParams(**ranks.FIT_PARAMS))
    assert_forests_equal(b.trees, ref_fit[0].trees)
    np.testing.assert_allclose(b.predict_margin(X), ref_fit[1], rtol=1e-4, atol=1e-5)
    # the port stages uint8: one wire byte a logical byte (the reference's
    # int32 upcast books four)
    assert b.stats.wire_bytes == b.stats.logical_bytes == b.stats.host_to_device_bytes > 0


def test_four_ranks_bitpack_bit_for_bit(spawned):
    raw, packed = (np.load(spawned / f"{c}_r0.npz") for c in ("fit_raw", "fit_bitpack"))
    for f in TreeArrays._fields:
        np.testing.assert_array_equal(packed[f"forest_{f}"], raw[f"forest_{f}"], err_msg=f)
    np.testing.assert_array_equal(packed["margin"], raw["margin"])
    assert 0 < packed["wire"] < packed["logical"] == raw["logical"] == raw["wire"]
    assert raw["logical"] == 1200 * 8  # every rank's block, summed


def test_four_ranks_f16_wire_stays_close(spawned):
    raw, f16 = (np.load(spawned / f"{c}_r0.npz") for c in ("fit_raw", "fit_f16"))
    assert_forests_equal(_forest(f16), _forest(raw), min_split_agreement=0.85,
                         leaf_rtol=5e-2, leaf_atol=5e-2)
    np.testing.assert_allclose(f16["margin"], raw["margin"], rtol=0.1, atol=0.05)
    assert abs(float(f16["eval_auc"]) - float(raw["eval_auc"])) <= 0.02


def test_four_ranks_sample_is_drawn_over_all_rows(spawned):
    got, core = (np.load(spawned / f"{c}_r0.npz") for c in ("fit_mvs", "core_mvs"))
    assert_forests_equal(_forest(got), _forest(core))


def test_four_ranks_spill_ledger(spawned):
    got = np.load(spawned / "fit_spill_r0.npz")
    assert int(got["spills"]) > 0 and int(got["fetch_bytes"]) > 0


def test_four_ranks_step_fn_lowers_logloss(spawned):
    losses = np.load(spawned / "step_r0.npz")["losses"]
    assert losses[-1] < losses[0], losses
    for r in range(1, ranks.WORLD):  # the gathered margins agree on every rank
        np.testing.assert_array_equal(np.load(spawned / f"step_r{r}.npz")["losses"], losses)


def test_four_ranks_collectives_booked(spawned):
    got = _rank_results(spawned, "collectives")
    assert all(int(r["all_reduce_calls"]) > 0 and int(r["all_reduce_bytes"]) > 0 for r in got)


def test_a_dead_rank_fails_the_others(spawned):
    for r in range(ranks.WORLD - 1):
        seen = (spawned / f"peer_failure_r{r}.txt").read_text()
        assert seen != "no error", f"rank {r}'s collective returned after a peer died"


# ------------------------------------------------------------ a world of one
@pytest.mark.parametrize("case", ["depthwise", "bf16", "feature_parallel"])
def test_world_of_one_matches_reference_mesh(prob, case):
    cfg = {"depthwise": {}, "bf16": {"hist_dtype": "bfloat16"},
           "feature_parallel": {"feature_axis": "model"}}[case]
    shape, names = ((1, 1), ("data", "model")) if cfg.get("feature_axis") else ((1,), ("data",))
    want, want_pos = j_grow_tree_distributed(
        jax.make_mesh(shape, names), prob.jbins, jnp.asarray(prob.g_np), jnp.asarray(prob.h_np),
        ranks.MAX_BIN, prob.jbv, JTreeParams(max_depth=ranks.DEPTH), JDistConfig(**cfg),
        prob.jell.cuts.values, prob.jell.cuts.ptrs,
    )
    got, got_pos = grow_tree_distributed(
        make_mesh(shape, names, device="cpu"), prob.bins, prob.g, prob.h, ranks.MAX_BIN, prob.bv,
        TreeParams(max_depth=ranks.DEPTH), DistConfig(**cfg), prob.ell.cuts.values,
        prob.ell.cuts.ptrs,
    )
    assert_trees_equal(got, want, got_positions=got_pos, want_positions=want_pos)


def test_world_of_one_lossguide_under_budget_matches_reference_mesh():
    # the inputs of test_histstore.py's distributed budget case
    from repro.data.pages import TransferStats as JTransferStats

    rng = np.random.default_rng(3)
    X = rng.normal(size=(896, 4)).astype(np.float32)
    g = rng.normal(size=896).astype(np.float32)
    h = rng.random(896).astype(np.float32) + 0.1
    jell = j_create(X, max_bin=8)
    ell = create_ellpack_inmemory(X, max_bin=8, device=CPU)
    kw = dict(grow_policy="lossguide", max_leaves=32)
    jstats, stats = JTransferStats(), TransferStats()
    want, want_pos = j_grow_tree_distributed(
        jax.make_mesh((1,), ("data",)), jnp.asarray(jell.single_page().bins.astype(np.int32)),
        jnp.asarray(g), jnp.asarray(h), 8, j_bin_valid(jell.cuts, 8),
        JTreeParams(max_depth=10, **kw),
        JDistConfig(hist_budget_bytes=2048, hist_retained_levels=2),
        jell.cuts.values, jell.cuts.ptrs, transfer_stats=jstats,
    )
    got, got_pos = grow_tree_distributed(
        make_mesh((1,), ("data",), device="cpu"), ell.single_page().bins, g, h, 8,
        bin_valid_from_cuts(ell.cuts, 8, CPU), TreeParams(max_depth=10, **kw),
        DistConfig(hist_budget_bytes=2048, hist_retained_levels=2),
        ell.cuts.values, ell.cuts.ptrs, transfer_stats=stats,
    )
    assert_trees_equal(got, want, got_positions=got_pos, want_positions=want_pos)
    assert stats.hist_spills == jstats.hist_spills > 0
    assert stats.hist_fetch_bytes == jstats.hist_fetch_bytes > 0


def test_world_of_one_bitpack_bit_for_bit():
    X, y = ranks.fit_inputs()
    mesh = make_mesh((1,), ("data",), device="cpu")
    params = BoosterParams(**ranks.FIT_PARAMS)
    dm = IterDMatrix([(X, y)], max_bin=16, device=CPU)
    raw = fit_sharded(mesh, dm, params=params)
    packed = fit_sharded(mesh, dm, params=params, cfg=DistConfig(page_codec="bitpack"))
    for a, b in zip(packed.trees, raw.trees):
        _assert_same_tree(a, b)
    assert 0 < packed.stats.wire_bytes < packed.stats.logical_bytes == raw.stats.logical_bytes


# ------------------------------------------------------------------- errors
def test_config_validation_matches_reference():
    for bad in (dict(grad_transport="int8"), dict(page_codec="gzip"),
                dict(page_codec="bitpack", feature_axis="model")):
        with pytest.raises(ValueError) as want:
            JDistConfig(**bad)
        with pytest.raises(ValueError) as got:
            DistConfig(**bad)
        assert str(got.value) == str(want.value)


def test_feature_parallel_lossguide_raises_clearly():
    X = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cfg = DistConfig(feature_axis="model", grow_policy="lossguide", max_leaves=8)
    with pytest.raises(NotImplementedError, match="feature-parallel lossguide"):
        fit_sharded(make_mesh((1, 1), ("data", "model"), device="cpu"), X, y,
                    params=BoosterParams(seed=0, max_depth=3, max_bin=16), cfg=cfg)
    with pytest.raises(NotImplementedError, match="feature-parallel lossguide"):
        check_feature_parallel_lossguide(
            TreeParams(max_depth=3, grow_policy="lossguide", max_leaves=8), cfg
        )


def test_make_gbdt_step_fn_rejects_lossguide():
    with pytest.raises(NotImplementedError, match="lossguide"):
        make_gbdt_step_fn(make_mesh((1,), ("data",), device="cpu"),
                          TreeParams(max_depth=3, grow_policy="lossguide"), 16, DistConfig())


def test_a_mesh_of_many_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no default process group"):
        make_mesh((2,), ("data",), device="cpu")


def test_divisibility_errors(monkeypatch):
    """Rows and features that do not divide over the mesh raise the
    reference's messages before any collective (a 4 x 2 mesh faked on one
    process: only its shape is read before the check)."""
    from repro_torch.distributed import gbdt_shard

    X = np.random.default_rng(1).normal(size=(66, 9)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    monkeypatch.setattr(mesh, "shape", {"data": 4, "model": 2})
    params = BoosterParams(seed=0, max_depth=3, max_bin=16)
    with pytest.raises(ValueError, match=r"n_rows=66 must divide evenly over the data axes"):
        fit_sharded(mesh, X, y, params=params)
    with pytest.raises(ValueError, match=r"num_features=9 must divide evenly over feature_axis"):
        fit_sharded(mesh, X[:64], y[:64], params=params, cfg=DistConfig(feature_axis="model"))
    assert gbdt_shard._shard_span(8, mesh, ("data",), "n_rows") == (0, 2)


# ---------------------------------------------------------- public surface
def test_public_surface_mirrors_the_reference():
    import repro.distributed as jd
    import repro.distributed.gbdt_shard as jshard
    import repro_torch.distributed as td

    names = [n for n in jd.__all__ if getattr(jd, n).__module__ == jshard.__name__]
    assert sorted(names) == sorted([
        "DistConfig", "check_feature_parallel_lossguide", "distributed_train_step",
        "fit_sharded", "grow_tree_distributed", "grow_tree_distributed_paged",
        "make_gbdt_step_fn", "sharded_page_put",
    ])
    for n in names:
        ours, theirs = getattr(td, n), getattr(jd, n)
        assert n in td.__all__
        if inspect.isfunction(theirs):
            assert list(inspect.signature(ours).parameters) == list(
                inspect.signature(theirs).parameters
            ), n
    assert [f.name for f in dataclasses.fields(td.DistConfig)] == [
        f.name for f in dataclasses.fields(jd.DistConfig)
    ]
    assert "make_mesh" in td.__all__ and "Mesh" in td.__all__
