"""Runs one cell of the port's benchmark once and prints its result as
the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
name from BENCHMARK.json (see benchmark/harness/cell.py). With --trace 0
the metrics are the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from a torch.profiler trace of the window. The
run needs a CUDA device and never falls back to the CPU; it fails, and
prints no result, if JAX or the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, manifest
    try:
        result = cell.run(manifest.load(ROOT), args.workload, args.seed,
                          args.seconds, bool(args.trace), T_START)
    except (cell.NoDevice, cell.ForbiddenModules) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
