"""Readings that the correctness limits are set from, on the card.

    python3 nddwt_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 3]

For each seed, in one process: the cell's set-up from that seed, a short
window at the cell's own load, and the comparison a run makes
(``err_max``: the program against the float64 reference); on the control
seeds also the control's reading on the same inputs
(``control_err_max``: the reference in bfloat16, or the kind's own
lower-precision path). One JSON line a seed.
"""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import json  # noqa: E402
import random  # noqa: E402

from nddwt_bench import harness  # noqa: E402


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device; this runs on the card only", file=sys.stderr)
        return 1
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    c = harness.resolve(bench, args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, state, sync, _ = harness.prepare(c, seed, "cuda")
        w = harness.run_window(c.kind, state, args.seconds, c.traffic["sync"] == "unit",
                               harness.Spans(), sync, c.traffic["check_samples"],
                               random.Random(seed))
        t1 = time.perf_counter()
        got = harness.compare(c.kind, state, w.kept, control=seed in controls)
        print(json.dumps({"workload": args.workload, "seed": seed, "units": w.units,
                          "err_max": got["err_max"], "errs": got["errs"],
                          "control_err_max": got.get("control_err_max"),
                          "setup_window_s": t1 - t0,
                          "compare_s": time.perf_counter() - t1}), flush=True)
        del state, w
        harness._free(True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
