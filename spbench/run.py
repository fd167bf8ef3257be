"""Run one cell of the benchmark once.

    python3 spbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix,
limits and metric readers are found by name (``spbench/core/spec.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from one profiled slice
of the window.  The last line of standard output is the result (JSON);
the last lines of standard error are the numbers compared, each beside
its limit.  Without a CUDA card (or with fewer cards than the cell
asks for), or where JAX or the JAX package was loaded, the run prints
no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The program's kernel builds stay in the checkout, at fixed paths.
BUILD = ROOT / "build"
os.environ["LEGATE_SPARSE_TPU_TORCH_BUILD_DIR"] = str(BUILD / "torch_kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# One thread of the host's for the process's own CPU work: the cells'
# launch-bound loops then compete with no helper thread for the cores
# that the machine's other work shares.
torch.set_num_threads(1)

from spbench.core import harness, spec  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("spbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"spbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0), T_START,
                         cell=cell)
    print(f"spbench: card {power_limit()}", file=sys.stderr)
    found = harness.jax_modules()
    if found:
        print(f"spbench: JAX modules loaded in this process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
