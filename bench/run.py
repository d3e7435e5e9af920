"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is the result's JSON object;
the numbers compared with the plain reference are the last lines of
standard error.  Without a card it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

if __name__ == "__main__":
    # one process a card, few host threads: the host's share of a run
    # stays steady
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    from benchkit.runner import main
    sys.exit(main(sys.argv[1:], T0, ROOT))
