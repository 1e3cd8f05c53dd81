"""Flow static analyzer CLI.

    python -m data_accelerator_tpu_torch.analysis flow.json [flow2.json ...]
        [--json] [--device] [--chips=1] [--udfs] [--all]

Each argument is a flow config file: either a designer gui JSON or a
full flow document (``{"gui": {...}}``). Prints one line per diagnostic
(or, with ``--json``, a machine-readable report per file) and exits
non-zero when any file has error-severity diagnostics: the CI self-lint
contract.

``--device`` additionally runs the device-plan tier
(``analysis/deviceplan.py``): every compiled view evaluated on ``meta``
tensors (no data, no device), printing the per-stage byte/FLOP cost
report and the DX2xx lints. Its error diagnostics fail the run the same
way the semantic tier's do. The port prices one card: ``--chips`` above
1 exits 2, naming multi-GPU slice 8. The latency model needs a
calibrated machine profile, which a design-time analysis has none of:
the report says ``uncalibrated`` and prints no milliseconds.

``--udfs`` additionally runs the UDF tier (``analysis/udfcheck.py``):
every declared UDF/UDAF resolves through the production loader and its
device functions' ASTs are abstract-interpreted under a taint lattice,
emitting the DX3xx lints. Same exit contract.

``--all`` runs every ported tier (semantic + device + udfs) with one
merged ``--json`` report, and names on stderr the tiers it left out.
The JAX package's other tiers are not ported yet: ``--compile``,
``--race``, ``--protocol``, ``--conf`` and ``--fleet`` (slice 7b) and
``--mesh`` (slice 8) exit 2 naming their slice, as do their value
flags (``--manifest=``, ``--manifest-out=``, ``--fleet-spec=``).

Unknown ``--`` flags are rejected with exit 2 (a typo like ``--devcie``
must not silently skip a tier and report a false clean pass).

Exit codes: 0 clean (warnings allowed) · 1 errors found · 2 usage/IO.

Copy of the JAX package's ``analysis/__main__.py`` trimmed to the
ported tiers; the report dicts and the 0/1/2 contract are the
reference's.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from ..core.config import EngineException


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GB"


def _fmt_count(n: float) -> str:
    for unit in ("", "k", "M", "G"):
        if abs(n) < 1000.0 or unit == "G":
            return f"{n:.1f}{unit}" if unit else f"{int(n)}"
        n /= 1000.0
    return f"{n:.1f}G"


def _print_device_plan(path: str, device) -> None:
    totals = device.totals()
    print(
        f"{path}: device plan ({device.chips} card): "
        f"{len(device.stages)} stage(s), "
        f"device bytes {_fmt_bytes(totals['hbmBytes'])} "
        f"(persistent {_fmt_bytes(totals['persistentBytes'])}, "
        f"per-batch {_fmt_bytes(totals['perBatchBytes'])}), "
        f"~{_fmt_count(totals['flops'])} FLOP/batch"
    )
    print(f"{path}: roofline latency: uncalibrated (no machine profile)")
    for s in device.stages:
        line = (
            f"{path}:   [{s.kind}] {s.name} rows={s.rows} "
            f"bytes={_fmt_bytes(s.hbm_bytes)}"
        )
        if s.flops:
            line += f" flops={_fmt_count(s.flops)}"
        if s.transient_bytes:
            line += f" transient={_fmt_bytes(s.transient_bytes)}"
        if s.detail:
            line += f" ({s.detail})"
        print(line)


# flags the CLI understands; anything else --prefixed is a usage error
KNOWN_FLAGS = {"--json", "--device", "--udfs", "--all"}
# the JAX package's tiers this port has not ported yet, by the slice
# that brings them
UNPORTED_FLAGS = {
    "--compile": "slice 7b (analysis/compilecheck.py)",
    "--race": "slice 7b (analysis/racecheck.py)",
    "--protocol": "slice 7b (analysis/protocheck.py)",
    "--conf": "slice 7b (analysis/confcheck.py)",
    "--fleet": "slice 7b (analysis/fleetcheck.py)",
    "--mesh": "multi-GPU slice 8 (analysis/meshcheck.py)",
}
UNPORTED_VALUE_FLAGS = {
    "--manifest=": "--compile", "--manifest-out=": "--compile",
    "--fleet-spec=": "--fleet",
}


def main(argv: List[str]) -> int:
    as_json = "--json" in argv
    all_tiers = "--all" in argv
    device_tier = "--device" in argv or all_tiers
    udf_tier = "--udfs" in argv or all_tiers
    chips: Optional[int] = None
    for a in argv:
        if not a.startswith("--") or a in KNOWN_FLAGS:
            continue
        if a.startswith("--chips="):
            from .chipcount import ChipCountError, parse_chip_count

            try:
                chips = parse_chip_count(a.split("=", 1)[1], "--chips")
            except ChipCountError as e:
                print(str(e), file=sys.stderr)
                return 2
            continue
        tier = UNPORTED_FLAGS.get(a) or next(
            (UNPORTED_FLAGS[t] for p, t in UNPORTED_VALUE_FLAGS.items()
             if a.startswith(p)), None,
        )
        if tier is not None:
            print(
                f"{a}: this tier is not ported to data_accelerator_tpu_torch "
                f"yet ({tier})", file=sys.stderr,
            )
            return 2
        print(f"unknown flag: {a}", file=sys.stderr)
        print(__doc__.strip(), file=sys.stderr)
        return 2
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    if all_tiers:
        print(
            "--all ran the ported tiers (semantic, device, udfs); not "
            "ported yet: " + ", ".join(
                f"{f} ({t})" for f, t in UNPORTED_FLAGS.items()
            ), file=sys.stderr,
        )

    from .analyzer import analyze_flow
    from .deviceplan import analyze_flow_device, combined_report_dict
    from .udfcheck import analyze_flow_udfs

    any_errors = False
    json_out = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                flow = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: cannot read flow config: {e}", file=sys.stderr)
            return 2
        report = analyze_flow(flow)
        try:
            device = (
                analyze_flow_device(flow, chips=chips) if device_tier else None
            )
        except EngineException as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 2
        udfs = analyze_flow_udfs(flow) if udf_tier else None
        any_errors |= not report.ok
        if device is not None:
            any_errors |= not device.ok
        if udfs is not None:
            any_errors |= not udfs.ok
        if as_json:
            if device is not None or udfs is not None:
                json_out.append({
                    "file": path,
                    **combined_report_dict(report, device, udfs),
                })
            else:
                json_out.append({"file": path, **report.to_dict()})
        else:
            diags = list(report.diagnostics) + (
                list(device.diagnostics) if device is not None else []
            ) + (list(udfs.diagnostics) if udfs is not None else [])
            for d in diags:
                print(f"{path}: {d.render()}")
            n_e = len([d for d in diags if d.is_error])
            n_w = len(diags) - n_e
            print(f"{path}: {n_e} error(s), {n_w} warning(s)")
            if device is not None and device.stages:
                _print_device_plan(path, device)
            if udfs is not None and udfs.udfs:
                for u in udfs.udfs:
                    roles = ",".join(u.analyzed) or "none"
                    print(
                        f"{path}: udf {u.name} [{u.tier}] "
                        f"{u.kind or 'unloadable'} ({u.path}) "
                        f"analyzed={roles}"
                    )

    if as_json:
        print(json.dumps(json_out if len(json_out) > 1 else json_out[0],
                         indent=2))
    return 1 if any_errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
