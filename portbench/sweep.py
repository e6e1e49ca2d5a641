"""The knee of a serving cell: its open loop at several fixed rates, in one
process (one set-up), to find the highest rate whose queue does not grow
through the window:

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> ...

For each rate one JSON line: requests offered and failed, the 50th and 95th
percentile time to first token over all of them and over the first and the
last third of the arrivals (a queue that grows shows as a last third far
behind the first), the time the drain took after the window, and the 95th
percentile time per output token. The cell's rate is then set, as a number,
in its traffic file at four fifths of the knee.
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
from portbench import port, yardstick  # noqa: E402
from portbench.cell import load_cell  # noqa: E402


def point(d, seconds: float, rate: float) -> dict:
    d.run(seconds, rate=rate)
    reqs = sorted(d.reqs, key=lambda q: q.due)
    ttft = [(q.first if q.first is not None else d.end) - q.due for q in reqs]
    third = max(1, len(ttft) // 3)
    e2e = d.end_to_end()
    return {"rate_per_s": rate, "offered": len(reqs), "failed": d.attempted_failed()[1],
            "ttft_p50_s": yardstick.percentile(ttft, 50), "ttft_p95_s": e2e["ttft_p95_s"],
            "ttft_p95_first_third_s": yardstick.percentile(ttft[:third], 95),
            "ttft_p95_last_third_s": yardstick.percentile(ttft[-third:], 95),
            "drain_s": d.end - max(q.due for q in reqs), "tpot_p95_ms": e2e["tpot_p95_ms"]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    port.build_kernels()
    cell = load_cell(run.ROOT, args.workload)
    d = run.driver_for(cell)(cell, args.seed, device, None)
    d.setup()
    card = torch.cuda.get_device_name()
    for rate in args.rates:
        t = time.perf_counter()
        line = dict(point(d, args.seconds, rate), card=card,
                    wall_s=round(time.perf_counter() - t, 1))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
