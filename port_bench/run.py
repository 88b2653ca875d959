"""Run one cell of the port's benchmark.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``cpu_path_tracing_tpu_torch``)
and ``BENCHMARK.json``, on a machine with the CUDA cards the cell asks for.
It prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` and ``checks``.  Without the cards it
asks for it exits non-zero and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def process_started() -> float:
    """The process's start on the ``time.perf_counter`` clock (from
    ``/proc``, to the tick; else the time this file began)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return min(STARTED, time.perf_counter() - (uptime - start))
    except (OSError, ValueError, IndexError):
        return STARTED


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import runner
    from harness.spec import Cell

    cell = Cell(args.workload)
    marks = [("imports", time.perf_counter())]
    import torch

    marks.append(("import torch", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    marks.append(("CUDA", time.perf_counter()))
    import cpu_path_tracing_tpu_torch  # noqa: F401  (fails here in a checkout without the port)

    marks.append(("import the port", time.perf_counter()))
    return runner.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      process_started(), marks=marks)


if __name__ == "__main__":
    sys.exit(main())
