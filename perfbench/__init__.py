"""The benchmark of `repro_torch`, the PyTorch and CUDA port: GBDT training
on the H100, driven by `BENCHMARK.json` at the repository root.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell. Every configuration, traffic mix, cell and
per-layer metric is a file of its own under this folder, found by name:

  configs/<config>.json     a deployment: data shape, scale, tree settings
  traffic/<mix>.json        a traffic mix: the training path and its knobs
  traffic/<generator>.py    a data generator, drawn on the card from the seed
  workloads/<cell>.json     a cell's own knobs and its correctness limits
  paths/<path>.py           how one training path is set up and timed
  metrics/<metric>.py       a per-layer metric's reader (and its counts)
  reference/                the plain reference that decides ``correct``
  yardstick/                peaks, trace reduction, device facts, spec loading
"""
