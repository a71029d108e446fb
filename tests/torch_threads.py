"""One torch intra-op thread per test process, for the port's tests.

Torch's CPU pool defaults to one thread a core, so six xdist workers on an
8-core host opened 48 threads between them; at one a worker the suite ran
~30 % faster, and two measured no faster. Every port test file that runs
on the CPU imports this module, so the cap holds in each worker that
collects one of them and in such a file run alone. `OMP_NUM_THREADS`
carries the cap to the CLI and torchrun children the tests start; a test
that gives its children a value of its own keeps that value.
"""

import os

import torch

TORCH_THREADS = 1

os.environ["OMP_NUM_THREADS"] = str(TORCH_THREADS)
torch.set_num_threads(TORCH_THREADS)
