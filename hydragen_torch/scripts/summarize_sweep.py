"""Aggregate synth sweep YAMLs into a markdown table.

Usage: python -m hydragen_torch.scripts.summarize_sweep DIR [DIR ...]
Prints one table per mode (rows = batch size, cols = shared prefix length,
cells = decode throughput tok/s) plus the 1K->16K retention per batch size,
the paper's "throughput drops <15% as the prefix grows 1K->16K" claim. It
reads the YAMLs of either package's synth and touches no device.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

from hydragen_torch.utils.results import SynthBenchmarkResult, load_yaml_dataclass


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dirs = [Path(d) for d in argv] or [Path("results/sweep_r2")]
    by_mode = defaultdict(dict)
    for d in dirs:
        for f in sorted(d.glob("*.yaml")):
            r = load_yaml_dataclass(SynthBenchmarkResult, f)
            tag = r.mode + (" (int8 KV)" if "kv8" in str(d) else "")
            by_mode[tag][(r.batch_size, r.num_shared)] = r.throughput

    for mode, cells in sorted(by_mode.items()):
        bss = sorted({b for b, _ in cells})
        nss = sorted({n for _, n in cells})
        print(f"\n### {mode}")
        print("| bs \\ prefix | " + " | ".join(str(n) for n in nss) + " | 1K->16K |")
        print("|---" * (len(nss) + 2) + "|")
        for b in bss:
            row = [cells.get((b, n)) for n in nss]
            lo, hi = cells.get((b, nss[0])), cells.get((b, nss[-1]))
            keep = f"{hi / lo * 100:.0f}%" if (lo and hi and nss[-1] >= 8 * nss[0]) else "-"
            print(
                f"| {b} | "
                + " | ".join("-" if v is None else f"{v:,.0f}" for v in row)
                + f" | {keep} |"
            )
    return by_mode


if __name__ == "__main__":
    main()
