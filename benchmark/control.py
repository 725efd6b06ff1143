"""Readings of the check at a cell's own size, on several seeds in one
process: the control (the reference computed in bfloat16, put in the
program's place) or the program itself, each through the harness's own
run with a short window, the check as a run makes it.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program] [--seconds 2]

Prints one JSON line per seed: {"seed", "solver", "correct", "numbers"},
the numbers the worst of the sampled frames. The benchmark's own runs do
not run the control; its readings set the upper end of each limit in
``checks/<cell>.json``, the program's the lower.
"""

import sys
import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    import argparse
    import json

    from pathlib import Path

    import torch

    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
    from harness import runner
    from reference import control
    from reference.surface import Params

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true", help="read the program, not the control")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = runner.load_json(runner.ROOT / "BENCHMARK.json")
    if args.program:
        solve = runner.program_for(spec, args.workload)[2]
    else:
        cfg = runner.cell_files(spec, args.workload)[1]
        p = Params.from_config(cfg)

        def solve(frame):
            return control.reconstruct(frame, p, device)
    for seed in args.seeds:
        t = time.perf_counter()
        out = runner.run(spec, args.workload, seed, args.seconds, False, device, solve, t,
                         warmup=args.program)
        res = out["result"]
        print(json.dumps({"seed": seed, "solver": "program" if args.program else "control",
                          "correct": res["correct"], "frames": res["attempted"],
                          "numbers": {k: c["value"] for k, c in res["check"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
