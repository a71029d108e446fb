"""The port tests' torch thread cap (`torch_threads.py`): inside a test
worker the process's intra-op pool and the `OMP_NUM_THREADS` its children
inherit both equal `TORCH_THREADS`, so six workers do not open a pool of
every core each; and every port test file that runs on the CPU imports the
module, so the cap also holds where that file runs alone."""

import ast
import os
from pathlib import Path

import torch

import torch_threads

# not the CPU's: the card's tests (they skip on the CPU), and a test of
# the JAX package's torch converters that is older than the port
LEFT_OUT = {"test_torch_cuda.py", "test_torch_port_roundtrip.py"}


def test_each_worker_runs_the_capped_torch_thread_count():
    assert torch.get_num_threads() == torch_threads.TORCH_THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(torch_threads.TORCH_THREADS)


def test_every_cpu_port_test_file_imports_the_cap():
    files = sorted(p for p in Path(__file__).parent.glob("test_torch_*.py")
                   if p.name not in LEFT_OUT)
    assert len(files) > 20
    for path in files:
        imported = {alias.name
                    for node in ast.parse(path.read_text()).body
                    if isinstance(node, ast.Import)
                    for alias in node.names}
        assert "torch_threads" in imported, path.name
