"""The port's kernels alone: ``chip_smoke.py``'s kernel phase with no path
driven.

Run from the root of a checkout: ``python3 kernel_times.py``. Each kernel is
built, held to its plain version and timed at the shapes the paths give it,
as in ``chip_smoke.py``. No path runs, so it prints no launch counts and no
success line: only ``python3 chip_smoke.py`` gives those. Copied with
``chip_smoke.py`` into another checkout (an older tree unpacked with ``git
archive``), it times that checkout's kernels, so two trees compare in one
run on one card.

``--split-policy`` also times K5 at ``chip_smoke.py``'s split shapes (one
32,768-key sequence over 8 kv heads, int8 and bf16) for each count of items
an SM that ``ops/flash.py:decode_splits`` could aim for, each held to the
plain version.

Prints the ``[kernel]`` records and, as the last line, one
``{"kernel_times": ...}`` JSON object. Exits 1 if a kernel disagrees with
its plain version, 2 without a CUDA device or the package beside the script.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

POLICY_PER_SM = (1, 2, 4, 8, 16)
POLICY_REPS = 3


def split_policy(failures: list) -> dict:
    """K5's device ms at the split shapes for each items-an-SM count: reps
    interleaved over the counts, each count's output held to the plain
    version once."""
    import chip_smoke
    from hydragen_torch.ops import flash
    from hydragen_torch.utils.timing import cuda_graph_time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    NL, b, hq, hkv, S, d = 2, 1, 32, 8, 32768, 128
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    shape = (NL, b, hkv, S, d)

    def case(dtype, filled):
        if dtype == torch.int8:
            k, v = (torch.randint(-127, 128, shape, dtype=dtype, device=dev, generator=g)
                    for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
                      for _ in range(2))
        else:
            k, v = (torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(2))
            ks = vs = None
        lens = torch.full((b,), filled, dtype=torch.int32, device=dev)

        def kw(i):
            sc = {} if ks is None else dict(k_scale=ks[i], v_scale=vs[i])
            return dict(kv_seq_lens=lens, **sc)

        def call(i):
            return flash.flash_attention_bhsd(q, k[i], v[i], **kw(i))

        ref = flash.flash_attention_bhsd_plain(q, k[NL - 1], v[NL - 1], **kw(NL - 1))[0]
        return call, ref

    cases = {torch.int8: case(torch.int8, S), torch.bfloat16: case(torch.bfloat16, S - 100)}
    keep = dict(flash.DECODE_WARPS_PER_SM)
    times: dict = {}
    try:
        for rep in range(POLICY_REPS):
            for per_sm in POLICY_PER_SM:
                for dtype, (call, ref) in cases.items():
                    flash.DECODE_WARPS_PER_SM[dtype] = per_sm
                    splits, chunk = flash.decode_splits(b * hkv, S, n_sm, per_sm)
                    name = f"{str(dtype).split('.')[-1]} {per_sm} an SM"
                    if rep == 0:
                        _, rel = chip_smoke.rel_err(call(NL - 1)[0], ref)
                        if rel > chip_smoke.TOL_REL:
                            failures.append(f"K5 split policy {name}: rel err {rel:.3g}")
                    ms = cuda_graph_time_ms(chip_smoke.Cycle(call, NL))
                    entry = times.setdefault(name, dict(splits=splits, chunk=chunk,
                                                        device_ms=[]))
                    entry["device_ms"].append(ms)
                    print(f"[split policy] rep {rep}: {name}: {splits} splits of {chunk}: "
                          f"{ms:.4f} ms (device, CUDA graph)", flush=True)
    finally:
        flash.DECODE_WARPS_PER_SM.update(keep)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split-policy", action="store_true",
                    help="also time K5's split shapes at each items-an-SM count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import chip_smoke
        from hydragen_torch.ops import cuda_lib
        from hydragen_torch.utils.timing import cuda_time_ms
    except ModuleNotFoundError as e:
        print(f"kernel_times: {e}: run this script from the root of a checkout of the port",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    cuda_lib.build()
    report: dict = {}
    failures: list[str] = []
    chip_smoke.check_kernels(report, failures, cuda_time_ms)
    if args.split_policy:
        report["k5_split_policy"] = split_policy(failures)
    if failures:
        print("kernel_times FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernel_times": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
