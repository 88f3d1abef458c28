"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object; the numbers that decided ``correct`` are the last
lines of standard error.  Exits 2 without a result where the checkout has
no port or torch sees fewer CUDA cards than the cell asks for, and 3 where
a module of JAX or of the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and the port's package, not this folder: its module
# names must not stand in for the standard library's
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
