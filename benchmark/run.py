"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(`gym_so100_tpu_torch`); see `benchmark/harness.py`.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / "_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / "_cache" / "torch_extensions")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "benchmark" / "_cache" / "torch_kernels")
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
