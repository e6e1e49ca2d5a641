"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (the directory holding ``BENCHMARK.json``). The
run builds the cell's inputs from ``--seed``, sets up the program and warms
up every shape the cell uses (``setup_s``: process start to the first timed
operation), measures for ``--seconds``, reads the device's peak memory,
frees the program's state, then judges what the window served against the
plain reference and prints, as the last line of its standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read from a
profiled stretch of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit.
The same checks are the last lines of its standard error.

It exits nonzero with no result where there is no CUDA device or fewer than
the cell asks for, and where JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Build and kernel caches at fixed paths inside the checkout, set before
# torch is imported. The port builds its kernels into build/kernels/ itself.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

import torch  # noqa: E402

from portbench import check, port  # noqa: E402
from portbench.cell import load_cell, make_weights  # noqa: E402
from portbench.timeline import Tracer, fence  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hydragen_tpu")


def log(msg: str) -> None:
    print(f"[portbench {time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


class Record:
    """What a per-layer metric's reader is given: the cell, the driver
    (its records, its work by phase, its requests) and the traced window's
    timeline (None where nothing was traced)."""

    def __init__(self, cell, driver, timeline):
        self.cell, self.driver, self.timeline = cell, driver, timeline


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def code_file(cell, sub: str, name: str) -> Path:
    """``<sub>/<name>.py`` beside the cell's files, else the benchmark's own."""
    path = cell.bench_dir / sub / f"{name}.py"
    return path if path.exists() else Path(__file__).resolve().parent / sub / f"{name}.py"


def driver_for(cell):
    """The ``Driver`` class of the cell's traffic kind (``drivers/<kind>.py``)."""
    kind = cell.traffic["kind"]
    return load_module(code_file(cell, "drivers", kind), f"portbench_driver_{kind}").Driver


def cell_metrics(cell, kind: str) -> list:
    """The entries of ``end_to_end`` or ``per_layer`` this cell reports: those
    that list it, and those with no list whose moved metric it reports."""
    e2e = [m["name"] for m in cell.bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    return [m for m in cell.bench[kind]
            if cell.name in m.get("workloads", [cell.name] if kind == "end_to_end"
                                  or m.get("moves") in e2e else [])]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device) -> dict:
    """One run of a cell (the command's body, without its device checks and
    printing); returns the result object."""
    cell = load_cell(root, workload)
    if device.type == "cuda":
        port.build_kernels()
    tracer = Tracer(device) if trace else None
    if tracer is not None:
        tracer.warm()
    d = driver_for(cell)(cell, seed, device, tracer)
    d.setup()
    fence(device)
    setup_s = time.perf_counter() - T_START
    log(f"{workload}: set up in {setup_s:.2f} s")
    d.run(seconds)
    fence(device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"window closed; device peak {peak / 2**30:.2f} GiB")
    attempted, failed = d.attempted_failed()
    metrics, extra = {}, {}
    if trace:
        rec = Record(cell, d, tracer.timeline)
        for m in cell_metrics(cell, "per_layer"):
            read = load_module(code_file(cell, "metrics", m["name"]),
                               "portbench_metric_" + m["name"].replace(".", "_")).read
            v = read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tl = tracer.timeline
        if tl is not None:
            extra = {"busy_s": tl.busy_s(), "window_s": tl.window_s}
            breakdown = tl.breakdown()
    else:
        e2e = dict(d.end_to_end(), setup_s=setup_s)
        for m in cell_metrics(cell, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    log("per-layer metrics read" if trace else "end-to-end metrics read")
    sample = d.sample()
    d.close()
    del d
    port.free()

    weights = make_weights(cell.config, seed, device)
    logits = check.reference_logits(sample, weights, cell.config, device)
    stats = check.gap_stats(check.served_gaps(sample, logits))
    del weights, logits
    correct, checks = check.judge({"mean_gap": stats["mean"], "failed": failed}, cell.limits)
    log(f"reference compared {sum(len(s) for s in sample.served)} served tokens; widest gap "
        f"{stats['max']!r}, share not the reference's best {stats['changed']!r} (not compared)")
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name() if device.type == "cuda"
                         else "cpu", "count": cell.chips, "memory_peak_bytes": peak, **extra}}
    if trace and tracer.timeline is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = int(load_cell(ROOT, args.workload).chips)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
