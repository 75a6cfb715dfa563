"""The rank programs of the sharded tests: four gloo ranks on the CPU.

Imports neither JAX nor the reference, so the spawned ranks start quickly.
Every rank runs every case on the same global inputs (the SPMD convention)
and writes its results to ``<out>/<case>_r<rank>.npz``; the test holds
them against the reference. Last, rank 3 exits abruptly while the others
enter an all-reduce: they must raise (not hang), and each records the
error it saw in ``<out>/peer_failure_r<rank>.txt``. `run_cuda` is the
rank program of the sharded cases of `test_torch_cuda.py`.
"""
from __future__ import annotations

import datetime
import os

import numpy as np

N_ROWS, N_FEATURES, MAX_BIN, DEPTH = 1024, 16, 16, 4
WORLD = 4
TIMEOUT_S = 60  # every collective ends within this, or raises


def inputs():
    """The reference test's inputs (`test_distributed.py`), for both packages."""
    from repro_torch.data.synthetic import make_classification

    X, y = make_classification(N_ROWS, N_FEATURES, seed=1)
    rng = np.random.default_rng(0)
    g = rng.normal(size=N_ROWS).astype(np.float32)
    h = np.ones(N_ROWS, np.float32)
    return X, y, g, h


def fit_inputs():
    """The IterDMatrix fit inputs of the sharded front-door cases."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1200, 8)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = ((X[:, 0] + 0.5 * np.nan_to_num(X[:, 1])) > 0).astype(np.float32)
    return X, y


FIT_PARAMS = dict(n_estimators=3, max_depth=4, max_bin=16, objective="binary:logistic", seed=0)


def _save(out: str, case: str, rank: int, tree=None, positions=None, **extra) -> None:
    arrays = {k: np.asarray(v) for k, v in extra.items()}
    if tree is not None:
        arrays.update({f"tree_{f}": getattr(tree, f).cpu().numpy() for f in tree._fields})
    if positions is not None:
        arrays["positions"] = positions.cpu().numpy()
    np.savez(os.path.join(out, f"{case}_r{rank}.npz"), **arrays)


def _forest(booster) -> dict:
    return {
        f"forest_{f}": np.stack([getattr(t, f).cpu().numpy() for t in booster.trees])
        for f in booster.trees[0]._fields
    }


def run(rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    from repro_torch.core.booster import BoosterParams, GradientBooster, bin_valid_from_cuts
    from repro_torch.core.ellpack import EllpackPage, create_ellpack_inmemory
    from repro_torch.core.objectives import logloss
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.sampling import SamplingConfig
    from repro_torch.core.tree import TreeParams
    from repro_torch.data.dmatrix import IterDMatrix
    from repro_torch.distributed import (
        DistConfig,
        fit_sharded,
        grow_tree_distributed,
        grow_tree_distributed_paged,
        make_gbdt_step_fn,
        make_mesh,
        sharded_page_put,
    )
    from repro_torch.pipeline import PageStream

    cpu = torch.device("cpu")
    X, y, g, h = inputs()
    ell = create_ellpack_inmemory(X, max_bin=MAX_BIN, device=cpu)
    bins = ell.single_page().bins
    bv = bin_valid_from_cuts(ell.cuts, MAX_BIN, cpu)
    cv, cp = ell.cuts.values, ell.cuts.ptrs
    tp = TreeParams(max_depth=DEPTH)
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")

    # grow_tree_distributed: data-parallel, 2 x 2, bf16 wire, lossguide
    cases = {
        "dp": (mesh, DistConfig()),
        "fp": (mesh2, DistConfig(feature_axis="model")),
        "bf16": (mesh, DistConfig(hist_dtype="bfloat16")),
        "lg": (mesh, DistConfig(grow_policy="lossguide", max_leaves=16)),
    }
    for case, (m, cfg) in cases.items():
        tree, pos = grow_tree_distributed(m, bins, g, h, MAX_BIN, bv, tp, cfg, cv, cp)
        _save(out, case, rank, tree, pos)

    # the paged build: each rank streams its row slice of 4 pages
    extents = [(i * 256, 256) for i in range(4)]
    pages = [EllpackPage(bins=bins[lo : lo + nr], row_offset=lo) for lo, nr in extents]
    put = sharded_page_put(mesh, DistConfig())

    def make_stream(indices=None):
        return PageStream.from_host_pages(pages, indices=indices, to_array=put, device="cpu")

    for case, ptp in (("paged", tp), ("paged_lg", TreeParams(max_depth=DEPTH,
                                                              grow_policy="lossguide",
                                                              max_leaves=16))):
        tree, pos = grow_tree_distributed_paged(
            mesh, make_stream, extents, g, h, MAX_BIN, bv, ptp, DistConfig(), cv, cp
        )
        _save(out, case, rank, tree, pos)

    # fit_sharded on an IterDMatrix: raw, bitpack, f16, sampled, the spill
    # ledger; the margins predicted by each rank
    Xf, yf = fit_inputs()
    dm = IterDMatrix([(Xf[:600], yf[:600]), (Xf[600:], yf[600:])], max_bin=16, device=cpu)
    params = BoosterParams(**FIT_PARAMS)
    fits = {
        "fit_raw": (params, DistConfig()),
        "fit_bitpack": (params, DistConfig(page_codec="bitpack")),
        "fit_f16": (params, DistConfig(grad_transport="f16")),
        "fit_mvs": (BoosterParams(**dict(FIT_PARAMS, sampling=SamplingConfig(method="mvs", f=0.5))),
                    DistConfig()),
        "fit_spill": (BoosterParams(**dict(FIT_PARAMS, n_estimators=2, max_depth=10)),
                      DistConfig(grow_policy="lossguide", max_leaves=24, hist_budget_bytes=1024)),
    }
    for case, (p, cfg) in fits.items():
        b = fit_sharded(mesh, dm, params=p, cfg=cfg, eval_set=(Xf, yf))
        st = b.stats
        _save(out, case, rank, margin=b.predict_margin(Xf), eval_auc=b.eval_history[-1].value,
              wire=st.wire_bytes, logical=st.logical_bytes, spills=st.hist_spills,
              fetch_bytes=st.hist_fetch_bytes, **_forest(b))
    # the port's own in-core fits on the same matrix, for the sampled case
    core = GradientBooster(fits["fit_mvs"][0], policy=ExecutionPolicy(mode="in_core"),
                           device=cpu).fit(dm)
    _save(out, "core_mvs", rank, **_forest(core))

    # make_gbdt_step_fn: three MVS steps lower the logloss
    step = make_gbdt_step_fn(mesh, tp, MAX_BIN, DistConfig(), learning_rate=0.3,
                             objective="binary:logistic", sampling_f=0.5)
    margin = torch.zeros(N_ROWS)
    losses = [logloss(y, torch.sigmoid(margin).numpy())]
    for i in range(3):
        margin, _ = step(bins, margin, y, bv, cv, cp, i)
        losses.append(logloss(y, torch.sigmoid(margin).numpy()))
    _save(out, "step", rank, losses=np.asarray(losses))
    _save(out, "collectives", rank, all_reduce_calls=mesh.stats.all_reduce_calls,
          all_reduce_bytes=mesh.stats.all_reduce_bytes)

    # a rank that dies: the others' next collective raises, within the timeout
    dist.barrier()
    if rank == WORLD - 1:
        os._exit(3)
    try:
        mesh.all_reduce(torch.ones(4), ("data",))
        seen = "no error"
    except Exception as err:  # recorded, then the rank fails as a real run would
        seen = f"{type(err).__name__}: {err}"
    with open(os.path.join(out, f"peer_failure_r{rank}.txt"), "w") as fh:
        fh.write(seen)
    os._exit(4)


# ----------------------------------------------------------- on the card
CUDA_FIT = dict(n_estimators=3, max_depth=5, max_bin=64, objective="binary:logistic", seed=0)


def cuda_fit_inputs():
    from repro_torch.data.synthetic import make_classification

    return make_classification(4000, 20, seed=7)


def run_cuda(rank: int, world: int, store: str, out: str, fail_rank: int) -> None:
    """``world`` gloo ranks sharing the card fit a forest with `fit_sharded`;
    rank ``fail_rank`` (if any) has a histogram kernel that raises, which
    must fail its run and, through the next collective, every other."""
    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    from repro_torch.core.booster import BoosterParams
    from repro_torch.distributed import fit_sharded, make_mesh
    from repro_torch.kernels import histogram

    if rank == fail_rank:
        def broken(*args, **kwargs):
            raise RuntimeError("injected kernel failure")

        histogram.build_histogram = broken
    X, y = cuda_fit_inputs()
    mesh = make_mesh((world,), ("data",))
    assert mesh.device.type == "cuda"
    b = fit_sharded(mesh, X, y, params=BoosterParams(**CUDA_FIT))
    _save(out, "cuda_fit", rank, **_forest(b))
    dist.destroy_process_group()


def paper_fit_inputs():
    """200,000 rows at the paper configuration's width (500 features)."""
    from repro_torch.data.synthetic import make_classification

    return make_classification(200_000, 500, seed=3)


PAPER_FIT = dict(n_estimators=4, max_depth=8, learning_rate=0.1, max_bin=256,
                 objective="binary:logistic", seed=0)


def run_cards(rank: int, world: int, store: str, out: str, backend: str) -> None:
    """One rank a card (``cuda:rank``): `fit_sharded` at the paper width
    over ``backend``; saves the forest and the rank's all-reduce ledger."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    from repro_torch.core.booster import BoosterParams
    from repro_torch.distributed import fit_sharded, make_mesh

    X, y = paper_fit_inputs()
    mesh = make_mesh((world,), ("data",))
    assert mesh.device == torch.device("cuda", rank), mesh.device
    fit_sharded(mesh, X, y, params=BoosterParams(**dict(PAPER_FIT, n_estimators=1)))  # warm-up
    mesh.stats.reset()
    b = fit_sharded(mesh, X, y, params=BoosterParams(**PAPER_FIT), eval_set=(X[:20_000], y[:20_000]))
    n = len(b.trees)
    _save(out, f"cards_{backend}", rank, per_tree_s=b.eval_history[-1].elapsed_s / n,
          eval_auc=b.eval_history[-1].value,
          all_reduce_s=mesh.stats.all_reduce_seconds / n,
          all_reduce_bytes=mesh.stats.all_reduce_bytes // n, **_forest(b))
    dist.destroy_process_group()
