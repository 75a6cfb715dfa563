"""Dry-run and roofline tables from the port's sweep artifacts.

Counterpart of `repro.roofline.report`: the same three tables, read from
``experiments/dryrun_torch/<mesh>/*.json`` (`repro_torch.launch.dryrun`).
The figures are modelled on one H100 SXM's constants
(`repro_torch.roofline.analysis.HW`), not measured.

    PYTHONPATH=src python -m repro_torch.roofline.report
"""
from __future__ import annotations

import glob
import json
import os

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")


def load(mesh: str, root: str = ROOT) -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(root, mesh, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def _fmt_bytes(b: float) -> str:
    return f"{b/2**30:.2f}"


def dryrun_table(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | status | bytes/dev (GiB) | peak est (GiB) | GFLOPs/dev | coll GiB/dev | compile s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | **{r['status']}** "
                f"| — | — | — | — | {r.get('compile_seconds','')} |"
            )
            continue
        ms = r["memory_stats"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {_fmt_bytes(r['bytes_per_device'])} "
            f"| {_fmt_bytes(ms.get('peak_estimate_bytes', 0))} "
            f"| {r['flops_per_device']/1e9:.0f} "
            f"| {_fmt_bytes(r['collective_bytes_per_device'])} "
            f"| {r['compile_seconds']} |"
        )
    return "\n".join(lines)


def roofline_table(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | MODEL_FLOPS | useful | next lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if r["status"] != "ok":
            continue
        lever = {
            "compute": "cut non-useful FLOPs (masked-attn block skipping, remat policy)",
            "memory": "fuse/cast intermediates (bf16), shrink logits & score buffers",
            "collective": "reshard to cut all-gathers; overlap with compute; compress payloads",
        }[r["dominant"]]
        useful = "—" if r["useful_ratio"] is None else f"{r['useful_ratio']:.3f}"
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"| **{r['dominant']}** | {r['model_flops']:.2e} | {useful} "
            f"| {lever} |"
        )
    return "\n".join(lines)


def collective_detail(cells: list[dict]) -> str:
    lines = ["| arch | shape | all-reduce | all-gather | reduce-scatter | all-to-all | permute |",
             "|---|---|---|---|---|---|---|"]
    for r in cells:
        if r["status"] != "ok":
            continue
        cb = r["collective_breakdown"]
        gib = lambda k: f"{cb.get(k, 0)/2**30:.3f}"  # noqa: E731
        lines.append(
            f"| {r['arch']} | {r['shape']} | {gib('all-reduce')} | {gib('all-gather')} "
            f"| {gib('reduce-scatter')} | {gib('all-to-all')} | {gib('collective-permute')} |"
        )
    return "\n".join(lines)


def main(root: str = ROOT):
    for mesh in ("16x16", "2x16x16"):
        cells = load(mesh, root)
        n_ok = sum(c["status"] == "ok" for c in cells)
        print(f"\n### Mesh {mesh} — {n_ok}/{len(cells)} cells compiled\n")
        print(dryrun_table(cells))
        if mesh == "16x16":
            print("\n### Roofline (single-pod, per assignment)\n")
            print(roofline_table(cells))
            print("\n### Collective payload breakdown (GiB/device, single-pod)\n")
            print(collective_detail(cells))


if __name__ == "__main__":
    main()
