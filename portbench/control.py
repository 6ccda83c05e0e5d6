"""Readings that set a cell's correctness limits; not run by the benchmark.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --mode program|control|half_batch|no_exchange|state_unchanged \
        [--out readings.jsonl]

``program``: the program's checked rounds at the cell's size against the
reference, one seed after another in this process (the lower readings).
``control``: the reference in the program's place with its products in
the configuration's control precision (``precision.control``: TF32 for a
float32 configuration, fp8 for bf16), against the reference (an upper
reading).  The other modes plant a fault in the program: ``half_batch``
trains on half of each minibatch, the mean taken over the rest;
``no_exchange`` leaves out the all-reduce between the cards of a mesh;
``state_unchanged`` makes the server step return its state.  Each seed
prints one JSON line of the compared numbers, judged against the cell's
limits as a run judges them: ``correct`` and the numbers that failed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "half_batch",
                             "no_exchange", "state_unchanged"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))
    import torch
    from portbench.harness import cell as cell_lib
    from portbench.harness.check import judge
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.mode == "control":
            nums = cell_lib.control_numbers(
                cell, seed, dev, cell.config["precision"]["control"])
        else:
            fault = None if args.mode == "program" else args.mode
            nums = cell_lib.check_numbers(cell, seed, dev, fault)
        correct, checks = judge(nums, cell.limits)
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "seed": seed, "seconds": time.time() - t0,
                           "correct": correct,
                           "failed": sorted(k for k, c in checks.items()
                                            if not c["value"] <= c["limit"]),
                           **nums})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
