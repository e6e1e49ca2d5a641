"""The readings a cell's limits are set from, on the chip at the cell's own
size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ...

For each seed the cell's program is set up and run for a short window at the
cell's own load (a generate cell: at least one whole call; a serving cell:
``--seconds`` of arrivals and the drain), and the plain reference reads the
gaps of the served tokens as a run does (the program's readings: their
mean, which is compared, and their widest, 99th percentile and share
changed). For each control seed the reference one precision step down
(int4 weights in groups of 128, int4 keys and values) is put in the
program's place over the same prompts and tokens, and the same is read of
the tokens it puts first (the control's readings). Each reading goes
through the run's own comparison (``check.judge`` against the cell's
limits, with the run's ``failed``), and its verdict is kept beside it: the
program's must come out correct and the control's not. Each seed's readings
are one JSON line on standard output and in
``build/portbench/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402  (sets the cache directories first)
from portbench import check, port  # noqa: E402
from portbench.cell import load_cell, make_weights  # noqa: E402
from portbench.timeline import fence  # noqa: E402

import torch  # noqa: E402


def readings(root: Path, workload: str, seed: int, seconds: float, control: bool,
             device) -> dict:
    """One seed's readings: ``program`` (``check.gap_stats`` of the served
    tokens), with ``control`` the control's (the same at int4 weights and
    KV), ``attempted``, ``failed``, and the verdict ``check.judge`` gives
    each (``program_correct``, ``control_correct``)."""
    cell = load_cell(root, workload)
    d = run.driver_for(cell)(cell, seed, device, None)
    d.setup()
    d.run(seconds)
    fence(device)
    attempted, failed = d.attempted_failed()
    sample = d.sample()
    d.close()
    del d
    port.free()
    w = make_weights(cell.config, seed, device)
    ref = check.reference_logits(sample, w, cell.config, device)
    out = {"program": check.gap_stats(check.served_gaps(sample, ref)),
           "attempted": attempted, "failed": failed}
    if control:
        low = check.reference_logits(sample, w, cell.config, device, w_bits=4, kv_bits=4)
        out["control"] = check.gap_stats(check.control_gaps(ref, low))
        del low
    for side in ("program", "control"):
        if side in out:
            out[f"{side}_correct"] = check.judge(
                {"mean_gap": out[side]["mean"], "failed": failed}, cell.limits)[0]
    del w, ref
    port.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    port.build_kernels()
    out = run.ROOT / "build" / "portbench" / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    jobs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    with out.open("a") as f:
        for seed, control in jobs:
            t = time.perf_counter()
            r = readings(run.ROOT, args.workload, seed, args.seconds, control, device)
            line = json.dumps({"workload": args.workload, "seed": seed, **r,
                               "seconds": round(time.perf_counter() - t, 1),
                               "card": torch.cuda.get_device_name(device)})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
