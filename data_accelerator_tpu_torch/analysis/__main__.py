"""Flow static analyzer CLI.

    python -m data_accelerator_tpu_torch.analysis flow.json [flow2.json ...]
        [--json] [--device] [--chips=N] [--udfs]
        [--fleet] [--fleet-spec=spec.json] [--fleet-device=cuda|cpu]
        [--compile] [--manifest=m.json] [--manifest-out=m.json]
        [--mesh] [--race] [--protocol] [--conf] [--all]

Each argument is a flow config file: either a designer gui JSON or a
full flow document (``{"gui": {...}}``). Prints one line per diagnostic
(or, with ``--json``, a machine-readable report per file) and exits
non-zero when any file has error-severity diagnostics: the CI self-lint
contract.

``--device`` additionally runs the device-plan tier
(``analysis/deviceplan.py``): every compiled view evaluated on ``meta``
tensors (no data, no device), printing the per-stage byte/FLOP cost
report and the DX2xx lints. Its error diagnostics fail the run the same
way the semantic tier's do. ``--chips=N`` sets the chip count for the
ICI model (default 1, one card). The latency model needs a calibrated
machine profile, which a design-time analysis has none of: the report
says ``uncalibrated`` and prints no milliseconds.

``--udfs`` additionally runs the UDF tier (``analysis/udfcheck.py``):
every declared UDF/UDAF resolves through the production loader and its
device functions' ASTs are abstract-interpreted under a taint lattice,
emitting the DX3xx lints. Same exit contract.

``--fleet`` runs the fleet tier (``analysis/fleetcheck.py``) over ALL
given flows AS A SET: first-fit-decreasing placement of each flow's
device-plan bytes onto the fleet's cards plus the DX4xx capacity and
interference lints. ``--fleet-spec=<file.json>`` sets the fleet (keys:
chips, hbmPerChipBytes, headroomFraction, d2hBytesPerSecPerChip,
iciBytesPerSecPerChip, iciTopology); what it leaves unset is the
machine's: the cards present and a card's memory, or with
``--fleet-device=cpu`` one device of ``CPU_DEVICE_MEMORY_BYTES``.
Without a card and without those keys it exits 2.

``--compile`` runs the compile-surface tier (``analysis/compilecheck.py``):
every entry point the flow dispatches (the step and one transfer
helper per output x capacity bucket: what ``FlowProcessor._aot_warm``
warms) with its signature, evaluated on ``meta``, the DX600 lint, and
the compile manifest (in ``--json`` under ``compile.manifest``;
``--manifest-out=<file>`` writes it, single flow only).
``--manifest=<file>`` checks a manifest for drift (DX602/DX603; digests
only against a manifest of the same digest backend).

``--mesh`` runs the mesh-sharding tier (``analysis/meshcheck.py``):
the flow's partition plan over a 1-D data mesh (per-stage shard axis,
forced reshard edges, closed-form collective bytes) with the DX7xx
lints, cross-checked EXACTLY against the census of the flow's mesh step
run once over virtual shards on ``meta`` (no data, no device).
``--chips=N`` sets the mesh size (default 8, one HGX H100 node); the one
``--chips`` flag feeds the device tier's ICI model and the mesh tier
alike, and a non-positive or non-integer value exits 2. DX702 holds the
per-chip bytes to the fleet spec of ``--fleet-spec``/``--fleet-device``,
as ``--fleet`` reads them: without a card, pass ``--fleet-device=cpu``
or a spec with ``hbmPerChipBytes``, else it exits 2. Same exit contract.

``--race``, ``--protocol`` and ``--conf`` run the engine gates over the
port's own source: buffer lifetime and locksets (``analysis/racecheck.py``,
DX80x), the exactly-once delivery ordering (``analysis/protocheck.py``,
DX90x) and the configuration lattice (``analysis/confcheck.py``, DX10xx,
plus this flow's knob values). Cached per engine-source state.

``--all`` runs every tier (semantic, device, udfs, fleet, compile,
mesh, race, protocol, conf) with one merged ``--json`` report.

Unknown ``--`` flags are rejected with exit 2 (a typo like ``--devcie``
must not silently skip a tier and report a false clean pass).

Exit codes: 0 clean (warnings allowed) · 1 errors found · 2 usage/IO.

Copy of the JAX package's ``analysis/__main__.py``; the report dicts
and the 0/1/2 contract are the reference's.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional


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
        f"{path}: device plan ({device.chips} card{'s' if device.chips > 1 else ''}): "
        f"{len(device.stages)} stage(s), "
        f"device bytes {_fmt_bytes(totals['hbmBytes'])} "
        f"(persistent {_fmt_bytes(totals['persistentBytes'])}, "
        f"per-batch {_fmt_bytes(totals['perBatchBytes'])}), "
        f"~{_fmt_count(totals['flops'])} FLOP/batch, "
        f"ICI {_fmt_bytes(totals['iciBytesPerBatch'])}/batch"
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
        if s.ici_bytes:
            line += f" ici={_fmt_bytes(s.ici_bytes)}"
        if s.detail:
            line += f" ({s.detail})"
        print(line)


def _print_mesh_plan(path: str, mesh) -> None:
    t = mesh.totals()
    state = "validated" if mesh.validated else "UNVALIDATED"
    print(
        f"{path}: mesh plan ({mesh.chips} chips, {state}): "
        f"{len(mesh.stages)} stage(s), "
        f"ICI {_fmt_bytes(t['iciWireBytesPerBatch'])}/batch wire "
        f"({_fmt_bytes(t['iciResultBytesPerBatch'])} result, "
        f"{t['reshardCount']} reshard(s)), "
        f"per-chip HBM {_fmt_bytes(t['perChipHbmBytes'])}"
    )
    for s in mesh.stages:
        line = (
            f"{path}:   [{s.kind}] {s.name} axis={s.axis} rows={s.rows} "
            f"per-chip={_fmt_bytes(s.per_chip_bytes)}"
        )
        if s.ici_wire_bytes:
            line += f" ici={_fmt_bytes(s.ici_wire_bytes)}"
        if s.detail:
            line += f" ({s.detail})"
        print(line)


def _print_fleet_plan(fleet) -> None:
    spec = fleet.spec
    plan = fleet.placement
    state = "feasible" if plan.feasible else "INFEASIBLE"
    print(
        f"fleet: {len(fleet.footprints)} flow(s) on {spec.chips} card(s) "
        f"x {_fmt_bytes(spec.hbm_per_chip_bytes)} "
        f"({spec.ici_topology}): {state}"
    )
    for chip in plan.chips:
        if not chip.flows:
            continue
        util = chip.utilization(spec)
        print(
            f"fleet:   card {chip.chip}: {', '.join(chip.flows)} — "
            f"{_fmt_bytes(chip.hbm_bytes)} ({util:.1%} used, "
            f"headroom {1 - util:.1%})"
        )
    for name in plan.oversized:
        print(f"fleet:   oversized (no card fits): {name}")
    for name in plan.unplaced:
        print(f"fleet:   unplaced (fleet oversubscribed): {name}")
    for name in plan.unanalyzed:
        print(f"fleet:   unanalyzed (no device footprint): {name}")


def _print_gates(path: str, comp, race, protocol, conf) -> None:
    if comp is not None and comp.entries:
        cd = comp.compile_dict()
        print(
            f"{path}: compile surface: {cd['entries']} entries "
            f"(1 step + {cd['helperEntries']} transfer-helper "
            f"over buckets {cd['buckets']}), "
            f"{'stable' if cd['stable'] else 'OPEN'}, "
            f"digests {cd['digestBackend']}"
        )
    if race is not None:
        rd = race.race_dict()
        print(
            f"{path}: race gate: {rd['analyzedFiles']} engine "
            f"module(s) analyzed, {rd['allowedZeroCopySites']} pinned "
            f"zero-copy site(s), {rd['ownerHandoffSites']} owner handoff(s)"
        )
    if protocol is not None:
        pd = protocol.protocol_dict()
        print(
            f"{path}: protocol gate: {pd['analyzedFiles']} "
            f"engine module(s) analyzed, {pd['effectEvents']} effect "
            f"event(s), {pd['postCommitSites']} pinned post-commit "
            f"site(s), {pd['requeueUpstreamSites']} requeue-upstream site(s)"
        )
    if conf is not None:
        cf = conf.conf_dict()
        print(
            f"{path}: conf gate: {cf['analyzedFiles']} module(s) scanned, "
            f"{cf['readSites']} read site(s) / {cf['readKeys']} key(s), "
            f"{cf['producedKeys']} produced key(s), "
            f"{cf['registryKeys']} registry row(s)"
        )


# flags the CLI understands; anything else --prefixed is a usage error
KNOWN_FLAGS = {"--json", "--device", "--udfs", "--fleet", "--compile",
               "--mesh", "--race", "--protocol", "--conf", "--all"}


def main(argv: List[str]) -> int:
    as_json = "--json" in argv
    all_tiers = "--all" in argv
    device_tier = "--device" in argv or all_tiers
    udf_tier = "--udfs" in argv or all_tiers
    fleet_tier = "--fleet" in argv or all_tiers
    compile_tier = "--compile" in argv or all_tiers
    mesh_tier = "--mesh" in argv or all_tiers
    race_tier = "--race" in argv or all_tiers
    protocol_tier = "--protocol" in argv or all_tiers
    conf_tier = "--conf" in argv or all_tiers
    chips: Optional[int] = None
    fleet_spec_path: Optional[str] = None
    fleet_device = "cuda"
    manifest_path: Optional[str] = None
    manifest_out: Optional[str] = None
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
        elif a.startswith("--fleet-spec="):
            fleet_spec_path = a.split("=", 1)[1]
        elif a.startswith("--fleet-device="):
            fleet_device = a.split("=", 1)[1]
        elif a.startswith("--manifest="):
            manifest_path = a.split("=", 1)[1]
        elif a.startswith("--manifest-out="):
            manifest_out = a.split("=", 1)[1]
        else:
            print(f"unknown flag: {a}", file=sys.stderr)
            print(__doc__.strip(), file=sys.stderr)
            return 2
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    if manifest_out and len(paths) > 1:
        print("--manifest-out accepts a single flow", file=sys.stderr)
        return 2

    from .analyzer import analyze_flow
    from .compilecheck import analyze_flow_compile
    from .confcheck import analyze_flow_conf
    from .deviceplan import analyze_flow_device, combined_report_dict
    from .diagnostics import REPORT_SCHEMA_VERSION
    from .meshcheck import analyze_flow_mesh
    from .protocheck import analyze_flow_protocol
    from .racecheck import analyze_flow_race
    from .udfcheck import analyze_flow_udfs

    shipped_manifest = None
    if manifest_path is not None:
        try:
            with open(manifest_path, "r", encoding="utf-8") as f:
                shipped_manifest = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{manifest_path}: cannot read manifest: {e}", file=sys.stderr)
            return 2

    fleet_spec = None
    if fleet_tier or mesh_tier:
        from .fleetcheck import FleetSpec, load_fleet_spec

        try:
            fleet_spec = (
                load_fleet_spec(fleet_spec_path, device=fleet_device)
                if fleet_spec_path is not None else FleetSpec(device=fleet_device)
            )
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            tier = "--fleet" if fleet_tier else "--mesh"
            print(f"{fleet_spec_path or tier}: cannot read fleet spec: {e}",
                  file=sys.stderr)
            return 2

    any_errors = False
    json_out = []
    flows: List[dict] = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                flow = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: cannot read flow config: {e}", file=sys.stderr)
            return 2
        flows.append(flow)
        report = analyze_flow(flow)
        device = analyze_flow_device(flow, chips=chips) if device_tier else None
        udfs = analyze_flow_udfs(flow) if udf_tier else None
        comp = (
            analyze_flow_compile(flow, manifest=shipped_manifest)
            if compile_tier else None
        )
        mesh = (
            analyze_flow_mesh(flow, chips=chips, spec=fleet_spec)
            if mesh_tier else None
        )
        race = analyze_flow_race(flow) if race_tier else None
        protocol = analyze_flow_protocol(flow) if protocol_tier else None
        conf = analyze_flow_conf(flow) if conf_tier else None
        tiers = [t for t in (report, device, udfs, comp, mesh, race, protocol,
                             conf) if t is not None]
        any_errors |= not all(t.ok for t in tiers)
        if comp is not None and manifest_out and comp.manifest is not None:
            with open(manifest_out, "w", encoding="utf-8") as f:
                json.dump(comp.manifest, f, indent=1)
        if as_json:
            if len(tiers) > 1:
                json_out.append({
                    "file": path,
                    **combined_report_dict(
                        report, device, udfs, compile_surface=comp,
                        mesh=mesh, race=race, protocol=protocol, conf=conf,
                    ),
                })
            else:
                json_out.append({"file": path, **report.to_dict()})
        else:
            diags = [d for t in tiers for d in t.diagnostics]
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
            if mesh is not None and mesh.stages:
                _print_mesh_plan(path, mesh)
            _print_gates(path, comp, race, protocol, conf)

    fleet = None
    if fleet_tier:
        from .fleetcheck import analyze_fleet_flows

        fleet = analyze_fleet_flows(flows, spec=fleet_spec)
        any_errors |= not fleet.ok
        if not as_json:
            for d in fleet.diagnostics:
                print(f"fleet: {d.render()}")
            print(f"fleet: {len(fleet.errors)} error(s), "
                  f"{len(fleet.warnings)} warning(s)")
            _print_fleet_plan(fleet)

    if as_json:
        if fleet is not None:
            print(json.dumps({
                "schemaVersion": REPORT_SCHEMA_VERSION,
                "files": json_out,
                **fleet.to_dict(),
            }, indent=2))
        else:
            print(json.dumps(json_out if len(json_out) > 1 else json_out[0],
                             indent=2))
    return 1 if any_errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
