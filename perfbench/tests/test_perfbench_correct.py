"""``correct`` on the CPU at a small size: a sound run of each cell comes
out correct, and the control and each planted fault under the timed path
come out not correct. The look for a card is skipped; the program runs its
plain versions on the host."""
import numpy as np
import pytest

import faults
import rehearsal

SEED = 2**31 + 977
ONE_CARD = ["xgb-paper.in_core", "xgb-paper.sampled", "higgs.in_core"]
FAULTS = {
    "xgb-paper.in_core": [faults.state_unchanged, faults.half_batch, faults.answer_altered],
    "xgb-paper.sampled": [faults.state_unchanged, faults.half_batch, faults.draw_altered,
                          faults.answer_altered],
    "higgs.in_core": [faults.state_unchanged, faults.half_batch, faults.answer_altered],
    "xgb-paper.allreduce4": [faults.exchange_left_out, faults.state_unchanged,
                             faults.half_batch, faults.answer_altered],
}


@pytest.fixture(autouse=True)
def _restore_program():
    """Faults patch the program's modules: undo it after each test."""
    import repro_torch.core.booster as booster_mod
    import repro_torch.core.sampling as sampling_mod
    import repro_torch.distributed.gbdt_shard as shard_mod

    saved = (booster_mod.grow_tree, booster_mod.sample, sampling_mod.sample,
             shard_mod._grow_tree_sharded, shard_mod.Mesh.all_reduce)
    yield
    (booster_mod.grow_tree, booster_mod.sample, sampling_mod.sample,
     shard_mod._grow_tree_sharded, shard_mod.Mesh.all_reduce) = saved


@pytest.mark.parametrize("cell", ONE_CARD + ["xgb-paper.allreduce4"])
def test_sound_run_is_correct(cell):
    res = rehearsal.run_small(cell, SEED)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_is_not_correct(cell):
    import control

    res = control.judge_control(rehearsal.small_cell(cell), SEED, "cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault):
    res = rehearsal.run_small(cell, SEED, fault=fault)
    assert not res["correct"], res["checks"]
    assert all(np.isfinite(c["limit"]) for c in res["checks"].values())


def test_readings_judge_sound_fits_and_planted_faults():
    """`perfbench/readings.py` at a small size: the sound fit holds the
    limits, each planted fault does not, and the program is whole again
    after each fault."""
    import readings

    cell = rehearsal.small_cell("xgb-paper.sampled")
    lines = list(readings.read(cell, [SEED, SEED + 1], ["half_batch", "draw_altered"], "cpu"))
    assert [(x["seed"], x["kind"]) for x in lines] == [
        (SEED, "sound"), (SEED, "half_batch"), (SEED, "draw_altered"), (SEED + 1, "sound")]
    assert [x["within_limits"] for x in lines] == [True, False, False, True]
    assert {"split_gap", "leaf_gap", "margin_gap", "kept_z", "draw_z"} <= set(lines[0]["nums"])
