"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with the card(s) the cell asks for. See
portbench/harness.py for how a cell is found and PERF.md for what it
measures.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel and compiler caches at fixed paths inside the checkout, so that
# only a checkout's first run builds; the program's own libraries go to
# echoflow_torch/_build/.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)
# The checkout's root in place of this file's folder, whose module names
# (trace, ...) would shadow others.
sys.path[0] = str(ROOT)

from portbench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T0))
