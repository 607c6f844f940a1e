"""Prefix every line of standard input with the seconds since this script
started, so that two runs of one program can be compared phase by phase.

    python3 -u chip_smoke.py 2>&1 | python3 experiments/stamp_lines.py > smoke.log

Run the program with ``python3 -u`` so that its lines arrive as it prints
them.
"""

import sys
import time


def main() -> None:
    t0 = time.perf_counter()
    for line in sys.stdin:
        sys.stdout.write(f"{time.perf_counter() - t0:9.1f} {line}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
