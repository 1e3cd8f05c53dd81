"""The benchmark's harness: find a cell's files by name, run its loop,
read its metrics, judge its outputs and print the result line.

Everything that belongs to one cell, configuration, traffic mix, loop,
metric or reference is a file of its own, found by the name that
``BENCHMARK.json`` and the cell's file give:

- ``workloads/<cell>.json``: the configuration, the traffic mix, the
  loop's parameters (rate, fill batches);
- ``configs/<config>/config.json``: the deployment, its conf and files;
  a streaming conf may declare more socket sources
  (``datax.job.input.sources.<name>.*``) beside its primary;
- ``traffic/<mix>.json``: the mix's parameters, which the one generator
  (``traffic/generator.py``) reads; its side streams (``streams``) feed
  the sources of the same names;
- ``loops/<loop>.py``: ``start_traffic(cell)``, ``stop_traffic``,
  ``run(cell, traffic, device)``, which drive the program and return
  the run's record, and ``shrink(cell)``, the cell at a CPU rehearsal's
  size;
- ``metrics/<metric>.py``: ``read(record)``, a number or None;
- ``reference/<config>.py``: ``judge(cell, record, outputs)``, the
  comparison with the plain reference that decides ``correct``, and
  ``control_outputs(cell, record)``, the reference one precision down
  in the program's place. A reference is plain NumPy or plain PyTorch
  on the CPU: it imports nothing of the program, of JAX or the JAX
  package, of ``chip_smoke`` or of the repository's tests; one that
  imports torch turns TF32 off (matmul and cuDNN) when it is imported
  and names ``device="cpu"`` and the dtype of every tensor it builds;
- ``roofline/<config>.py``: the bytes a step must move.

A later cell, configuration, mix or metric is new files and new
``BENCHMARK.json`` entries; no file here changes. The CPU rehearsal and
the card's tests take their cells from ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the build and kernel caches of the program, at fixed paths inside the
# checkout: only a cell's first run there builds
CACHE_DIR = HERE / ".cache"
# top-level module names that may not be loaded in the process that
# prints a result: JAX and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "data_accelerator_tpu")


def proc_start_boot_s() -> float:
    """This process's start on CLOCK_BOOTTIME (from /proc/self/stat)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def boot_at(mono: float) -> float:
    """A ``time.monotonic()`` instant on CLOCK_BOOTTIME."""
    return time.clock_gettime(time.CLOCK_BOOTTIME) - (time.monotonic() - mono)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"streambench_{kind}_{name.replace('.', '_').replace('-', '_')}", path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` and the files its names lead to."""

    name: str
    seed: int
    seconds: float
    trace: bool
    bench: dict
    workload: dict
    config: dict
    config_dir: Path
    mix: dict
    mix_path: Path
    tmp: Path
    proc_start: float

    @property
    def entry(self) -> dict:
        return next(w for w in self.bench["workloads"] if w["name"] == self.name)

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        moved = {m["name"] for m in self.end_to_end()}

        def applies(m):
            if "workloads" in m:
                return self.name in m["workloads"]
            return m["moves"] in moved

        return [m for m in self.bench["per_layer"] if applies(m)]

    def materialize_conf(self, job: Path, out: Path, extra: dict) -> Path:
        """The configuration's conf with its placeholders filled, plus
        ``extra`` keys, written under ``job``."""
        text = (self.config_dir / self.config["conf"]).read_text(encoding="utf-8")
        for k, v in {"@CONF@": str(self.config_dir), "@JOB@": str(job),
                     "@OUT@": str(out), "@CACHE@": str(CACHE_DIR)}.items():
            text = text.replace(k, v)
        text += "".join(f"{k}={v}\n" for k, v in extra.items())
        path = job / f"{self.config['name']}.conf"
        path.write_text(text, encoding="utf-8")
        return path


def find_cell(name: str, seed: int, seconds: float, trace: bool,
              bench_path: Optional[Path] = None) -> Cell:
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if name not in names:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {names}")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config_dir = HERE / "configs" / workload["config"]
    mix_path = HERE / "traffic" / f"{workload['traffic']}.json"
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = Path(tempfile.mkdtemp(prefix="streambench-", dir=base))
    return Cell(
        name=name, seed=seed, seconds=seconds, trace=trace, bench=bench,
        workload=workload, config=load_json(config_dir / "config.json"),
        config_dir=config_dir, mix=load_json(mix_path), mix_path=mix_path,
        tmp=tmp, proc_start=proc_start_boot_s(),
    )


def set_cache_env() -> None:
    """Point every build and kernel cache the program could use at fixed
    directories inside the checkout; keep libraries from loading JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    CACHE_DIR.mkdir(parents=True, exist_ok=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "unknown"


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def read_metrics(cell: Cell, record: dict) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or its per-layer
    ones (``--trace 1``), each from its own reader; a reader that finds
    nothing to read returns None, and the metric is left out."""
    metrics = {}
    for m in (cell.per_layer() if cell.trace else cell.end_to_end()):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def run_cell(cell: Cell, device: str = "cuda", traffic=None, control: bool = False):
    """Run the cell; returns (its result line as a dict, the lines to
    print on standard error before the checks). ``device`` other than
    ``"cuda"`` is the CPU rehearsal of the tests; the command itself
    always runs on the card. ``control``: judge the reference computed
    one precision below the program's, in the program's place, over the
    run's own batches, instead of the program's rows (the comparison
    must find it wrong)."""
    loop = load_module("loops", cell.workload["loop"])
    if traffic is None:
        traffic = loop.start_traffic(cell)
    record = loop.run(cell, traffic, device)
    reference = load_module("reference", cell.workload["config"])
    outputs = reference.control_outputs(cell, record) if control else None
    verdict = reference.judge(cell, record, outputs)
    metrics = read_metrics(cell, record)
    result = {
        "correct": bool(verdict["correct"] and not record["failed"]),
        "attempted": int(record["attempted"]),
        "failed": int(record["failed"]),
        "metrics": metrics,
        "device": dict(record["device"]),
    }
    if cell.trace and record.get("profile"):
        prof = record["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    result["checks"] = verdict["checks"]
    return result, record.get("lines", []) + verdict.get("lines", [])


def print_result(result: dict, extra_lines: list) -> None:
    """The comparisons as the last lines on standard error, then the
    result as the last line on standard output, its checks last."""
    for line in extra_lines:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # internal: the knee sweep's offered rate in place of the cell's
    ap.add_argument("--rate", type=float, default=None)
    # internal: run the control (see run_cell) instead of judging the program
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    cell = find_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    if a.rate is not None:
        cell.workload["rate"] = a.rate
    set_cache_env()
    loop = load_module("loops", cell.workload["loop"])
    # the generator builds its events while the program starts
    traffic = loop.start_traffic(cell)
    try:
        import torch

        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"streambench: the cell needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        print(json.dumps({
            "card": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi(),
            "workload": cell.name, "seed": cell.seed,
            "seconds": cell.seconds, "trace": int(cell.trace),
        }), flush=True)
        result, lines = run_cell(cell, "cuda", traffic, control=a.control)
    finally:
        loop.stop_traffic(traffic)
        shutil.rmtree(cell.tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"streambench: modules of JAX or the JAX package were "
              f"loaded: {found}", file=sys.stderr)
        return 3
    print_result(result, lines)
    return 0
