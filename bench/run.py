"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload c2c_lb.n16384 --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``).  The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
compared, each beside its limit.  ``--rehearse`` runs the cell on the CPU
at its traffic's tiny sizes through the kernels' plain versions, and prints
its numbers under ``rehearsal`` only.  Exit codes: 0 a result, 2 no card
(or fewer than the cell needs), 3 JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """Import ``bench`` as a package from the checkout, never its files as
    top-level modules, and the program from ``src``.  Kernel caches stay at
    fixed paths inside the checkout: the program's own library goes to
    ``build/`` there by itself, and a Triton or extension kernel that a
    later change brings finds its cache set here, beside it."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rehearse", action="store_true",
                        help="on the CPU at the traffic's tiny sizes")
    args = parser.parse_args(argv)

    from bench import harness, registry
    imported = time.perf_counter()
    chips = int(registry.workload(registry.benchmark(), args.workload)["chips"])
    if not args.rehearse:
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {chips} CUDA device(s), found {found}",
                  file=sys.stderr)
            return 2
        torch.cuda.init()
    looked = time.perf_counter()
    result, notes, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        rehearse=args.rehearse, started=STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        print("forbidden modules loaded: " + ", ".join(loaded), file=sys.stderr)
        return 3
    notes.insert(0, f"setup s: interpreter and imports {imported - STARTED:.2f}, "
                    f"CUDA start {looked - imported:.2f}")
    for line in notes + checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _paths()
    sys.exit(main())
