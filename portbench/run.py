"""Run one cell of the port's benchmark once, on the card this process sees.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration
(``portbench/configs/<config>.json``, which names its reference task under
``portbench/reference/``), its traffic (``portbench/traffic/<traffic>.json``,
which names its loop, ``portbench/loops/<loop>.py``), the limits of its
check (``portbench/limits/<cell>.json``) and its metrics (each read by
``portbench/metrics/<metric>.py``) are found by the names in
``BENCHMARK.json``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` with ``--trace 1``), then ``checks``, each number the
check compared beside its limit; the same numbers end standard error.
With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from a traced window.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache a library may keep lives at a fixed path inside the checkout
for variable, folder in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                         ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[variable] = str(ROOT / ".portbench_cache" / folder)
os.environ["USE_FLAX"] = "0"
# one process, one host thread for the host-side tensor work: idle worker
# threads would take the cores the launching thread needs
os.environ["OMP_NUM_THREADS"] = "1"
# the benchmark's modules are imported as the package portbench, never by bare name
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != BENCH]

FORBIDDEN = ("jax", "jaxlib", "flax", "gymnasium_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def cell_metrics(manifest: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with a trace its per-layer ones (a metric without ``workloads`` in
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def fail(message: str, code: int) -> None:
    print(message, file=sys.stderr)
    sys.exit(code)


def resolve(manifest: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """The cell's entry, configuration, traffic and limits, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    entry = cells[workload]
    config = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    if isinstance(config["num_envs"], dict):  # a batch for each traffic mix
        config = dict(config, num_envs=config["num_envs"][entry["traffic"]])
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())["limits"]
    return entry, config, traffic, limits


def run_cell(manifest: dict, workload: str, seed: int, seconds: float, traced: bool, device) -> tuple[dict, list]:
    """One run of a cell on ``device``: the result line (its keys in the
    order they are printed) and each compared number beside its limit."""
    import torch

    from portbench import drive, trace
    from portbench.check import judge

    entry, config, traffic, limits = resolve(manifest, workload)
    counts_name = config.get("kernel_counts")
    counts = json.loads((BENCH / "counts" / f"{counts_name}.json").read_text()) if counts_name else None
    peaks = json.loads((BENCH / "peaks.json").read_text())
    cell = drive.Cell(workload, config, traffic, seed, seconds, device, STARTED, counts, peaks)
    result = drive.run(cell, traced)

    wanted = cell_metrics(manifest, workload, traced)
    metrics, extra = {}, {}
    if traced:
        read = trace.readers(BENCH / "metrics")
        for m in wanted:
            value = read[m["name"]](result["trace"]) if m["name"] in read else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": result["trace"].busy_s(),
                 "window_s": (result["trace"].end_us - result["trace"].start_us) / 1e6}
    else:
        values = dict(result["metrics"], setup_s=result["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted if m["name"] in values}
    correct, lines = judge(result["readings"], limits)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    line = {
        "correct": correct,
        "attempted": result["units"],
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": entry["chips"],
                   "memory_peak_bytes": result["memory_peak_bytes"], **extra},
    }
    if traced:
        line["breakdown"] = trace.breakdown(result["trace"])
    line["checks"] = {x["name"]: {"value": x["value"], "limit": x["limit"]} for x in lines}
    info = {k: v for k, v in result["readings"].items() if k.startswith("_")}
    print(json.dumps({"readings_info": info, "window_s": result.get("window_s")}), file=sys.stderr)
    return line, lines


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        entry = resolve(manifest, args.workload)[0]
    except KeyError as e:
        fail(str(e), 2)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"{args.workload} needs {entry['chips']} CUDA device(s); "
             f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    import gymnasium_tpu_torch

    if ROOT not in Path(gymnasium_tpu_torch.__file__).resolve().parents:
        fail(f"the program must come from this checkout, not {gymnasium_tpu_torch.__file__}", 3)

    line, lines = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}", 4)
    for x in lines:
        print(f"check {x['name']}: {x['value']!r} (limit {x['limit']!r}) {'ok' if x['ok'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
