"""The port's roofline (`repro_torch.roofline`): H100 constants, the model
FLOPs against the reference's, `CostMode`'s tallies on programs whose
costs are known by hand (a DTensor program's collectives on a fake 2 x 2
world, matmul FLOPs, bytes, the peak of live bytes), and the three report
tables string-equal to `repro.roofline.report`'s on the same cell dicts.
"""
import copy

import pytest
import torch

from repro.roofline import report as j_report
from repro.roofline.analysis import model_flops as j_model_flops
from repro_torch.launch.dryrun import fake_world
from repro_torch.roofline import HW, CostMode, analyze_traced, model_flops
from repro_torch.roofline import report


def test_hw_constants_are_the_h100s():
    assert HW.peak_flops == 989e12  # bf16 dense, H100 SXM
    assert HW.hbm_bw == 3.35e12  # HBM3
    assert HW.nvlink_bw == 450e9  # NVLink 4, a direction
    assert HW.network_bw == 50e9  # one 400 Gb/s NDR link a card
    assert HW.collective_bw(8) == HW.nvlink_bw
    assert HW.collective_bw(256) == HW.collective_bw(512) == HW.network_bw


@pytest.mark.parametrize("n,tokens", [(1e9, 1000), (1_235_814_400, 1_048_576), (7, 3)])
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_flops_match_reference(n, tokens, kind):
    assert model_flops(n, tokens, kind) == j_model_flops(n, tokens, kind)


def test_cost_mode_books_local_collectives_flops_bytes():
    """On a fake 2 x 2 (data, model) world: a (64, 32) f32 sharded over data
    and gathered (one all-gather of the 8 KiB whole), a partial sum over
    model reduced (all-reduce of the 32 x 32 local block) and one reduced
    onto a data shard (reduce-scatter to 16 x 32), and a local matmul whose
    FLOPs are those of the 32 x 32 x 16 shard product, not of the global
    one (DTensor's own shape propagation on fake tensors is not counted)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh

    with fake_world(4):
        mesh = make_host_mesh(2, 2, device_type="cpu")
        x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(32, 16, device="meta"), mesh,
                              [Replicate(), Replicate()])
        part = DTensor.from_local(torch.empty(32, 32, device="meta"), mesh,
                                  [Replicate(), Partial()], run_check=False)
        part2 = DTensor.from_local(torch.empty(32, 32, device="meta"), mesh,
                                   [Partial(), Replicate()], run_check=False)
        cost = CostMode()
        with cost:
            cost.start()
            x.redistribute(mesh, [Replicate(), Replicate()])
            part.redistribute(mesh, [Replicate(), Replicate()])
            part2.redistribute(mesh, [Shard(0), Replicate()])
            y = x @ w
    assert cost.collectives == {"all-gather": 64 * 32 * 4, "all-reduce": 32 * 32 * 4,
                                "reduce-scatter": 16 * 32 * 4}
    assert cost.flops == 2 * 32 * 32 * 16
    assert y.to_local().shape == (32, 16)
    rep = analyze_traced(cost, arch="a", shape="s", mesh_name="2x2", chips=4,
                         n_active_params=10, tokens=3, kind="serve")
    assert rep.collective_bytes_per_device == sum(cost.collectives.values())
    assert rep.collective_s == rep.collective_bytes_per_device / HW.nvlink_bw
    assert rep.useful_ratio == 60 / (4 * cost.flops)


def test_cost_mode_bytes_and_peak():
    a = torch.ones(1000)
    cost = CostMode()
    with cost:
        cost.track(a)
        cost.start()
        b = a + 1  # reads 4000 B, writes 4000 B
        v = b.view(10, 100)  # a view moves nothing
        c = b * 2
        del b, v, c
        d = torch.zeros(500)  # writes 2000 B
        del d
    assert cost.bytes == 4000 * 2 + 4000 * 2 + 2000
    assert cost.argument_bytes == 4000
    assert cost.peak == 4000 + 4000 + 4000  # a, b and c live together
    assert cost.live == 4000
    assert cost.flops == 0
    rep = analyze_traced(cost, arch="a", shape="s", mesh_name="1", chips=1,
                         n_active_params=1, tokens=1, kind="train")
    assert rep.useful_ratio is None  # no FLOPs counted
    assert rep.memory_stats == {"argument_size_in_bytes": 4000, "temp_size_in_bytes": 8000,
                                "peak_estimate_bytes": 12000}


def _cells():
    ok = {
        "arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16", "chips": 256,
        "flops_per_device": 5.3e13, "bytes_per_device": 2.6e12,
        "collective_bytes_per_device": 5.4e10,
        "collective_breakdown": {"all-gather": 4.6e10, "all-to-all": 5.8e9,
                                 "reduce-scatter": 1.8e9, "all-reduce": 5.3e5},
        "compute_s": 0.0537, "memory_s": 0.797, "collective_s": 1.085,
        "dominant": "collective", "model_flops": 7.77e15, "useful_ratio": 0.571,
        "memory_stats": {"peak_estimate_bytes": 9.87e9}, "status": "ok",
        "compile_seconds": 16.9,
    }
    mem = dict(copy.deepcopy(ok), shape="prefill_32k", dominant="memory",
               collective_breakdown={"collective-permute": 2**30})
    comp = dict(copy.deepcopy(ok), shape="decode_32k", dominant="compute", useful_ratio=1.0)
    err = {"arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "16x16", "status": "error",
           "error": "RuntimeError: x", "compile_seconds": 3.2}
    return [ok, err, mem, comp]


@pytest.mark.parametrize("table", ["dryrun_table", "roofline_table", "collective_detail"])
def test_report_tables_match_reference(table):
    cells = _cells()
    assert getattr(report, table)(cells) == getattr(j_report, table)(cells)


def test_report_reads_the_sweep_layout(tmp_path, capsys):
    import json

    for c in _cells():
        d = tmp_path / c["mesh"]
        d.mkdir(exist_ok=True)
        (d / f"{c['arch']}__{c['shape']}.json").write_text(json.dumps(c))
    gbdt = dict(_cells()[0], arch="xgb-paper", shape="boost_1m", useful_ratio=None)
    (tmp_path / "16x16" / "xgb-paper__boost_1m.json").write_text(json.dumps(gbdt))
    report.main(str(tmp_path))
    out = capsys.readouterr().out
    assert "### Mesh 16x16 — 4/5 cells compiled" in out
    assert "| xgb-paper | boost_1m " in out and "| — |" in out
