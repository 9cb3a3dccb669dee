"""Run one cell of the benchmark of agc_tpu_torch, the PyTorch and CUDA port.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result as one JSON object;
the last lines of standard error are the numbers that decide ``correct``,
each beside its limit. No card, a module of JAX or of agc_tpu loaded, or a
checkout without the program: a nonzero exit and no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this folder, so no module here shadows
# a library's (and the program is the checkout's own)
sys.path[0] = str(Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    try:
        spec = harness.find_cell(args.workload)
        harness.card_check(spec.chips)
    except (LookupError, harness.NoCard) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
