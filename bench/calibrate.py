"""Read the numbers that set a cell's correctness limits, on the card.

    python3 bench/calibrate.py --workload c2c_lb.n16384 \
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --control-seeds 31,32,33

In one process: for each ``--seeds`` seed a short run of the cell as the
benchmark runs it (the program's readings), and for each
``--control-seeds`` seed the same run with the check's ``control`` (the
plain reference in the precision below the configuration's) in the
program's place.  Prints a JSON line a run, then the largest program
reading and the smallest control reading of each number.  The benchmark's
own runs never run the control.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import _paths  # noqa: E402  (bench/ is this script's directory)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args(argv)

    from bench import harness, registry
    cell = harness.load_cell(args.workload, False, args.rehearse)
    check = registry.code("checks", cell.config["check"])
    # A run compares an answer of every shape: send at least one block.
    block = sum(int(w) for _, w in cell.traffic["n"])
    readings = {"program": [], "control": []}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        wrap = None if side == "program" else (lambda fn: check.control)
        for seed in (int(s) for s in seeds.split(",")):
            result, _, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                            rehearse=args.rehearse, wrap=wrap,
                                            min_requests=block)
            numbers = {k: v["value"] for k, v in result["checks"].items()}
            readings[side].append(numbers)
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                              "attempted": result["attempted"],
                              "failed": result["failed"], **numbers}), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(r[k] for r in readings["program"]) for k in check.NUMBERS},
        "upper": {k: min(r[k] for r in readings["control"]) for k in check.NUMBERS},
        "seconds": time.perf_counter() - STARTED}), flush=True)
    return 0


if __name__ == "__main__":
    _paths()
    sys.exit(main())
