"""The port's benchmark: one run of one cell, one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of about ``--seconds``; ``--trace 1``
profiles a slice of rounds and times each layer alone, and reports the
per-layer metrics and a breakdown.  Either way set-up first drives the
program through its first rounds and the plain reference checks them
(``correct``).  The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error.  Exits non-zero, with no result, without enough CUDA cards, outside
a checkout that holds the system, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.time()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths():
    """The checkout's ``src`` (the system) and root (this package) on the
    path; the program's kernel caches inside the checkout."""
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    from portbench.harness import cell as cell_lib
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the system)
    out = cell_lib.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda"), T_START)
    bad = sorted(set(out.pop("_forbidden"))
                 | set(cell_lib.forbidden_modules()))
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    nums = out.pop("_numbers")
    phases = " ".join(f"{k} {v:.2f}" for k, v in out.pop("_phases").items())
    print(f"set-up phases: {phases}", file=sys.stderr)
    chunks = out.pop("_chunk_ms", None)
    if chunks:
        print("chunk ms a round: " + " ".join(f"{x:.2f}" for x in chunks),
              file=sys.stderr)
    print(f"worst leaves: grad {nums['_grad_leaf']}, change "
          f"{nums['_change_leaf']}", file=sys.stderr)
    for name in ("ids_mismatch", "loss_gap", "grad_gap", "change_gap",
                 "grad_row_median_gap", "change_row_median_gap"):
        if name not in out["checks"]:
            print(f"reading {name} {nums[name]!r} (not limited)",
                  file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
