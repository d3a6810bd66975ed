#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card: the numbers
``correct`` compares, from the program's sound runs over many seeds and
from the control, in one process.

    python3 port_bench/readings.py --workload c2c_1d.bulk --seconds 3 \\
        --seeds 11 12 13 ... --control-seeds 21 22 23

Set-up is made once; each seed then gets its own inputs and a short window
at the cell's own load, checked as a run checks it.  The control is the
configuration's reference in TF32 (``configs/<config>.py`` ``control``) put
in the program's place.  One JSON line a seed and side, then the largest
program reading and the smallest control reading of each call spec.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from port_bench import run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    run.pin_environment(os.environ)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import portfft_tpu_torch as pf

    cell = run.CellRun(run.Bench(run.ROOT), pf, args.workload, "cuda")
    cell.make_inputs(args.seeds[0])
    cell.commit()
    cell.warmup()
    program = list(cell.fns)
    control = [lambda x, s=spec.as_dict(): cell.ref.control(x, s) for spec in cell.specs]
    worst = {"program": {}, "control": {}}
    for side, fns, seeds in (("program", program, args.seeds),
                             ("control", control, args.control_seeds)):
        cell.fns = fns
        for seed in seeds:
            cell.make_inputs(seed)
            win = cell.window(args.seconds, seed)
            checks = cell.check(win["kept"])
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                              "calls": len(win["calls"]), "failed": win["failed"],
                              "readings": {k: v for k, (v, _) in checks.items()}}),
                  flush=True)
            for name, (value, _) in checks.items():
                pick = max if side == "program" else min
                worst[side][name] = pick(worst[side].get(name, value), value)
    print(json.dumps({"workload": args.workload, "lower": worst["program"],
                      "upper": worst["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
