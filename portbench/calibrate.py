"""The readings that a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 3] [--faults 3]

For each seed it sets the cell up as a run does (a training cell through
its checked steps; a serving cell through a short window of `--seconds`
at the cell's own load), then reads the numbers of the program and of the
control (the reference in fp8 in the program's place). Then, on the
first `--faults` seeds, each fault the cell can have, planted in the
program. One JSON line a reading on standard output. The benchmark's own
runs never run this.
"""

import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

def one(spec, seed, seconds, plant, control):
    from portbench import harness

    loop = harness.loop_for(spec, seed, "cuda", plant)
    t0 = time.perf_counter()
    loop.setup()
    if loop.kind == "serve":
        loop.window(seconds)
    loop.release()
    out = loop.readings(control=control, detail=True)
    return {"seed": seed, "plant": plant,
            "seconds": time.perf_counter() - t0, **out}


def main(argv=None) -> int:
    import argparse

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--witness", action="store_true",
                   help="run the program in float32 (compute and weights, "
                   "TF32 off) instead: a second witness of what bf16 "
                   "rounding does")
    args = p.parse_args(argv)
    spec = harness.cell(args.workload)
    if args.witness:
        import torch
        spec.config.update(compute_dtype="float32", param_dtype="float32")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    harness.check_device(spec.chips)
    print(json.dumps({"card": harness.power_limit()}), flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        print(json.dumps(one(spec, seed, args.seconds, None, True)),
              flush=True)
    for plant in harness.loop_for(spec, seeds[0], "cpu").PLANTS:
        for seed in seeds[:args.faults]:
            print(json.dumps(one(spec, seed, args.seconds, plant, False)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
