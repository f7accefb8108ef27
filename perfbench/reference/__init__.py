"""Plain references, in PyTorch, of what each cell's timed path computes.
They import nothing of ``repro_torch`` and take nothing it made: they work
from the same seeded inputs (``perfbench.inputs``) and read the program's
outputs only to judge them."""
