"""The control of a cell's comparison, read on the card at the cell's own
size: for each seed, a short window of the program at the cell's load, then
the numbers the check compares, read for the program and for the control,
the plain reference one precision down put in the program's place (16-bit
DP cells for the scores; bfloat16 accumulators for the pileup).  The
program's numbers must stay within their limits and the control's must
not.  The benchmark's own runs never run this.

    python3 -m mapbench.control --workload <cell> --seconds 5 \\
        --seeds 101 102 103
"""

from __future__ import annotations

import argparse
import json
import sys

from mapbench import cell as cells
from mapbench import run as run_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = cells.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("mapbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    failed = 0
    for seed in args.seeds:
        out, judged = run_mod.run_cell(spec, seed, args.seconds, False,
                                       control=True, emit=lambda s: None)
        print("control " + json.dumps(dict(
            workload=args.workload, seed=seed, program=judged["numbers"],
            control=judged["control"], limits=judged["limits"],
            program_correct=judged["correct"],
            control_correct=judged["control_correct"])), flush=True)
        failed += (not judged["correct"]) or judged["control_correct"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
