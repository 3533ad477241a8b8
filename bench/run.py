"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 bench/run.py --workload W --seed N --seconds T --trace 0|1

from the root of a checkout. Prints one JSON line last on standard
output (see ``bench/harness/main.py``); exits non-zero without it when
there is no CUDA device or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent

if __name__ == "__main__":
    # every cache of the run at a fixed place inside the checkout; the
    # port's kernels build into build/kernels/ there by themselves
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(REPO / "build" / "bench-cache" / sub)
    # one process with few threads: the step's host work is dispatch
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(BENCH), str(REPO / "src")]
    from harness.main import main
    sys.exit(main(t_start=T_START))
