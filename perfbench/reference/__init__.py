"""The plain reference that decides ``correct``: plain PyTorch in float64,
on the arrays the benchmark handed the program. It imports nothing of the
program and takes nothing the program made: it works the cuts, the bins
and each tree's statistics out again, and reads the program's outputs
(cuts, bins, trees, margins, sampled rows) only to judge them."""
