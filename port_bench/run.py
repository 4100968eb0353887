"""The benchmark of ``proben_tpu_torch`` on NVIDIA GPUs: one run of one cell
of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the run's log and its checks on
standard error and one JSON result as the last line of standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the traced window. Exits non-zero, printing no
result, without enough CUDA devices, without the program, or when JAX or
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "proben_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that this process may not hold."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT)]
    cache = ROOT / "build" / "port_bench_cache"  # fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch

    from harness import cells

    cell = cells.Cell(ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = cells.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = loaded_forbidden()
    if found:
        print(f"port_bench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
