"""Run one benchmark cell once and print its result line:

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. It measures the PyTorch/CUDA package
`imagecaptioning_tpu_torch` on the CUDA card, and exits non-zero with no
result where there is no card or the package is missing.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or PyTorch may write stays at a fixed place in
# the checkout, so a cell's second run finds what its first one built
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the checkout's root in place of this script's folder, whose module
# names would shadow others (`trace`)
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    if not (ROOT / "imagecaptioning_tpu_torch").is_dir():
        print("portbench: the package under test, imagecaptioning_tpu_torch, "
              "is not in this checkout", file=sys.stderr)
        sys.exit(2)
    from portbench import harness
    sys.exit(harness.main(t_start=T_START))
