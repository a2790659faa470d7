"""Run one cell of the port's benchmark once, on the card.

    python3 nddwt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, and with
``--trace 1`` a ``breakdown``; the compared numbers with their limits come
last, under ``checks``, and as the last lines on standard error). Exits
non-zero, printing no result, without enough CUDA devices or where the run
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, is where modules are found.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from nddwt_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
