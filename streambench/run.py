"""Run one cell of the port's benchmark on the card.

    python3 streambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process a run: set-up (the program's start, the traffic's pool, the
warm-up the cell needs), a measured window of ``--seconds``, the
comparison with the plain reference, and one JSON result line as the
last line of standard output. Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from streambench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
