"""The control of ``correct``, at a cell's own size on the card.

    python portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, one run of the cell whose program is given its inputs with
every N stored as A (a store of two bits a base) and is judged against the
true inputs: ``samples_wrong`` has to come out above its limit. The
benchmark's own runs never run this. Prints one JSON line a seed.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1)
    args = ap.parse_args(argv)

    from portbench import harness

    spec = harness.find_cell(args.workload)
    harness.card_check(spec.chips)
    for seed in args.seeds:
        r = harness.run_cell(spec, seed, args.seconds, False, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
