"""The readings the correctness limits are set from, on the card.

    python solverbench/calibrate.py --workload tall.shared \
        --seeds 101 102 ... --control-seeds 201 202 203 --seconds 20

runs, in one process, the cell once per seed as the benchmark runs it
(``harness.cell.run_cell``), then for each control seed two controls: the
plain reference put in the program's place and computed in TF32, the
nearest precision below the fp32 (TF32 off) the configuration states
(``harness.cell.reference_control``), and the cell run once more with the
program's own bf16 path switched on (x streamed in bf16, lower still).
Each prints one JSON line with the numbers the check compares; the last
line gives, for each number, the largest reading of the program and the
smallest of the controls: the lower and the upper reading a limit lies
between.  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (sets the caches and the import path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    from harness import spec
    from harness.cell import reference_control, run_cell
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve_cell(args.workload)
    lower, upper = {}, {}
    runs = [(s, "program") for s in args.seeds]
    runs += [(s, side) for s in args.control_seeds
             for side in ("control_tf32_reference", "control_bf16_program")]
    for seed, side in runs:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "side": side, "seed": seed}
        if side == "control_tf32_reference":
            readings = reference_control(cell, seed=seed, device="cuda:0")
        else:
            out = run_cell(cell, seed=seed, seconds=args.seconds,
                           trace=False, device="cuda:0", t_start=t0,
                           precision="bf16" if "bf16" in side else None)
            readings = out.readings
            line["compared"] = out.result["attempted"] - out.result["failed"]
            line["metrics"] = {k: v["value"]
                               for k, v in out.result["metrics"].items()}
            del out
        line["readings"] = readings
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        for name, value in readings.items():
            if side == "program":
                lower[name] = max(lower.get(name, float("-inf")), value)
            else:
                upper[name] = min(upper.get(name, float("inf")), value)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "forbidden_modules":
                      run.forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
