"""Machine-profile calibration: the time axis of the cost model.

The DX2xx closed forms predict *bytes and FLOPs*; turning those into
predicted *milliseconds* needs the machine constants of the device this
process runs on — memory stream bandwidth, dense FLOP/s, the fixed cost
of one dispatch, and device-to-host bandwidth. This module measures them
once per process and device with torch micro-probes, so the roofline
latency model (``analysis/costmodel.py stage_time_ms``) and the DX52x
runtime conformance checks (``obs/conformance.py``) judge observations
against *this machine*, not a datasheet.

Probe design (each: warm once, take the best of a few reps — bandwidth
is a max, overhead a min, so best-of is the right estimator):

- **hbm read GB/s**: sum-reduce a large float32 tensor (reads N).
- **hbm write GB/s**: fill the same tensor in place (writes N).
- **flops GFLOP/s**: one square float32 matmul (2*n^3 FLOPs).
- **dispatch overhead µs**: an in-place scalar add, timed per call up
  to a ``torch.cuda.synchronize()`` — the fixed cost of getting any
  step onto the device and learning it finished.
- **d2h GB/s**: a non-blocking copy into page-locked host memory, then
  a synchronize: the copy the collect stage makes (``PendingBatch``).
- **decode rows/s**: the port's own native decoder
  (``native/decoder.py``) over a reference payload.
- **ici GB/s** (``ici_probe``): an all-reduce across the distinct cards
  the process sees, made of peer copies (reduce to the first card, then
  broadcast), priced with the ring all-reduce wire bytes
  (``costmodel.allreduce_wire_bytes``). It stays inside the process: a
  collective across ranks would have to run in every rank at once, which
  a per-process, cached calibration cannot promise. One card, virtual
  shards of one card and the CPU have no link to measure: ``ici_gbps``
  stays None, as the reference's probe on a one-device host.

On the CPU the bandwidth and FLOP probes are wall-clock times less the
measured dispatch cost, as in the reference. On a card they are the
card's own time of the kernel, from CUDA events around back-to-back
launches: the wall clock less a host-timed tick read an H100's write
rate at 3,368-3,573 GB/s, over its published 3,350. The dispatch and
D2H probes are wall-clock times to a ``torch.cuda.synchronize()``.

Copy of the JAX package's ``obs/calibrate.py`` with torch probes.
Differences:

- On a card the memory probes stream ``CARD_L2_MULTIPLE`` times the L2
  cache that the card reports, so that they measure HBM and not the
  cache, and the matmul is ``CARD_MATMUL_N`` square; on the CPU the
  reference's sizes stay (``PROBE_ELEMS``, ``PROBE_MATMUL_N``).
- The probes' device memory is invisible to the flow's peak: the
  matmul's cuBLAS workspace is released, and when the probe raised the
  allocator's peak, calibration resets it once the probe is freed, and
  hands the probe's cached blocks back.
- The ICI probe moves ``CARD_ICI_ELEMS`` float32 a card (the
  reference's ``PROBE_ELEMS // 8`` a device is latency, not bandwidth,
  on NVLink). No ``DEFAULT_PROFILE``: the reference's is a TPU
  datasheet; a tier that prices without a measured profile says
  ``uncalibrated``.
- The process cache holds one profile per device, so a CPU profile
  never prices a card's stages, nor the reverse.
- ``backend`` is ``torch-cuda`` or ``torch-cpu``: a profile that the
  JAX package persisted to the same file or store (backend ``cpu``,
  ``gpu`` or ``tpu``, other probes) is never taken, nor the reverse.

The profile persists as JSON — locally (``calibrationfile``) and through
the shared object store (``calibrationurl``, an ``objstore://`` URL) so
a fleet of hosts on identical hardware calibrates once. A cached profile
is only reused for the same backend + device kind. Every field exports
as a ``Calib_*`` registry series.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple

import torch

from ..core.config import EngineException

logger = logging.getLogger(__name__)

# CPU probe sizing (the reference's): big enough to stream past a CPU's
# caches, small enough that the whole calibration stays ~100 ms
PROBE_ELEMS = 1 << 20  # 4 MiB of f32; also the D2H probe's size
PROBE_MATMUL_N = 256
# card probe sizing: the memory probes stream this many times the L2
# cache the card reports (the H100's 50 MB L2 would otherwise hold a
# 4 MiB probe whole), and the matmul is big enough to leave launch cost
CARD_L2_MULTIPLE = 16
CARD_MATMUL_N = 2048
# back-to-back launches a card probe's CUDA events enclose
CARD_LAUNCHES = 4
# float32 a card the ICI probe all-reduces (64 MiB: past launch latency)
CARD_ICI_ELEMS = 1 << 24
# best-of over enough reps to shrug off scheduler noise on a loaded
# host (bandwidth probes are single-digit ms; reps are cheap)
PROBE_REPS = 8
DISPATCH_REPS = 10

# the version stamp persisted profiles carry; bump when probe semantics
# change so stale cached profiles recalibrate instead of mispredicting
PROFILE_VERSION = 2

# decode probe sizing: enough rows that per-call overhead vanishes,
# small enough to stay ~10 ms
DECODE_PROBE_ROWS = 20_000


@dataclass
class MachineProfile:
    """Measured machine constants the latency closed forms consume."""

    backend: str
    device_kind: str
    hbm_read_gbps: float
    hbm_write_gbps: float
    flops_gflops: float
    dispatch_overhead_us: float
    d2h_gbps: float
    ici_gbps: Optional[float] = None
    # measured native ingest-decode rate over the reference payload
    # (rows/s; None when the native library is unavailable) — prices
    # the latency model's host-decode term so DX520 can judge
    # stage_decode_ms
    decode_rows_per_sec: Optional[float] = None
    probe_ms: float = 0.0
    version: int = PROFILE_VERSION

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, obj: dict) -> Optional["MachineProfile"]:
        try:
            known = {f for f in cls.__dataclass_fields__}  # noqa: SLF001
            return cls(**{k: v for k, v in obj.items() if k in known})
        except (TypeError, ValueError):
            return None

    def metrics(self) -> Dict[str, float]:
        """The ``Calib_*`` registry series."""
        out = {
            "Calib_HbmReadGBps": self.hbm_read_gbps,
            "Calib_HbmWriteGBps": self.hbm_write_gbps,
            "Calib_FlopsGFlops": self.flops_gflops,
            "Calib_DispatchOverheadUs": self.dispatch_overhead_us,
            "Calib_D2HGBps": self.d2h_gbps,
        }
        if self.ici_gbps is not None:
            out["Calib_IciGBps"] = self.ici_gbps
        if self.decode_rows_per_sec is not None:
            out["Calib_DecodeRowsPerSec"] = self.decode_rows_per_sec
        return out


def device_identity(device="cuda") -> Tuple[torch.device, str, str]:
    """``(device, backend, device_kind)`` of ``device``, its index
    resolved on a card; raises without one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise EngineException(
                f"calibration device {str(dev)!r}: no CUDA device is present "
                "(pass device='cpu' to calibrate the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, "torch-cuda", torch.cuda.get_device_name(dev)
    return dev, f"torch-{dev.type}", dev.type


def _best_seconds(fn, reps: int = PROBE_REPS) -> float:
    """Min wall time of ``fn()`` over ``reps`` runs (after the caller
    warmed it): the least-interfered-with sample."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)


def _probe_decode_rate() -> Optional[float]:
    """Measure the port's native ingest decoder on a reference
    IoT-shaped payload (nested object, string + numeric + timestamp
    columns) — rows/s on THIS host, the constant the latency model's
    decode term is priced with. None when the decoder cannot be built
    (the decode prediction then stays silent, like a missing ICI
    link)."""
    try:
        from ..core.schema import Schema, StringDictionary
        from ..native import NativeDecoder

        schema = Schema.from_spark_json(json.dumps({
            "type": "struct",
            "fields": [
                {"name": "d", "type": {"type": "struct", "fields": [
                    {"name": "id", "type": "long", "nullable": False,
                     "metadata": {}},
                    {"name": "kind", "type": "string", "nullable": False,
                     "metadata": {}},
                    {"name": "value", "type": "double", "nullable": False,
                     "metadata": {}},
                ]}, "nullable": False, "metadata": {}},
                {"name": "ts", "type": "timestamp", "nullable": True,
                 "metadata": {}},
            ],
        }))
        n = DECODE_PROBE_ROWS
        payload = ("\n".join(
            '{"d":{"id":%d,"kind":"K%d","value":%d.%03d},"ts":%d}'
            % (i % 97, i % 7, i % 100, i % 1000, 1_700_000_000_000 + i)
            for i in range(n)
        ) + "\n").encode()
        dec = NativeDecoder(schema, StringDictionary())
        try:
            dec.decode(payload, n)  # warm (build/trie/dict)
            best = _best_seconds(lambda: dec.decode(payload, n), reps=3)
        finally:
            dec.close()
        return round(n / best, 1)
    except Exception as e:  # noqa: BLE001 — the decode term is optional
        logger.debug("decode-rate probe unavailable: %s", e)
        return None


def _device_seconds(fn, launches: int = CARD_LAUNCHES,
                    reps: int = PROBE_REPS) -> float:
    """Best-of device time of one ``fn()`` on the current card: CUDA
    events around ``launches`` back-to-back launches, so the card never
    waits on the host between them."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / launches)
    return max(best, 1e-9)


def ici_probe(device="cuda") -> Tuple[Optional[float], str]:
    """``(GB/s, how)``: the interconnect rate of an all-reduce across
    the distinct cards this process sees, priced with the ring
    all-reduce wire bytes, and how it was measured; or ``(None, why
    not)``."""
    from ..analysis.costmodel import allreduce_wire_bytes

    dev = torch.device(device)
    if dev.type != "cuda":
        return None, f"{dev.type}: no interconnect to probe"
    n = torch.cuda.device_count()
    if n < 2:
        return None, (
            f"{n} card(s) visible: an all-reduce needs two distinct cards "
            "(virtual shards of one card share its memory, with no link)"
        )
    cards = [torch.device("cuda", i) for i in range(n)]
    try:
        parts = [torch.ones(CARD_ICI_ELEMS, dtype=torch.float32, device=c)
                 for c in cards]
        inbox = [torch.empty_like(parts[0]) for _ in cards[1:]]

        def reduce():
            # reduce to the first card, then broadcast: 2 S (n - 1) bytes
            # cross the links, as the ring closed form counts
            for buf, part in zip(inbox, parts[1:]):
                buf.copy_(part, non_blocking=True)
            total = parts[0].clone()
            for buf in inbox:
                total.add_(buf)
            for part in parts[1:]:
                part.copy_(total, non_blocking=True)
            for c in cards:
                torch.cuda.synchronize(c)

        reduce()
        secs = _best_seconds(reduce)
    except Exception as e:  # noqa: BLE001 — the ICI term is optional
        return None, f"ici probe failed: {e}"
    wire = allreduce_wire_bytes(CARD_ICI_ELEMS * 4, n)
    return wire / secs / 1e9, f"peer-copy all-reduce over {n} cards"


def calibrate(device="cuda") -> MachineProfile:
    """Run the micro-probes on ``device`` (the card by default; raises
    without one) and return a fresh profile."""
    t_start = time.perf_counter()
    dev, backend, kind = device_identity(device)
    on_card = dev.type == "cuda"
    if on_card:
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        elems = max(PROBE_ELEMS, CARD_L2_MULTIPLE * l2 // 4)
        mm_n = CARD_MATMUL_N
        peak_before = torch.cuda.max_memory_allocated(dev)

        def done():
            torch.cuda.synchronize(dev)
    else:
        elems, mm_n = PROBE_ELEMS, PROBE_MATMUL_N

        def done():
            pass

    with torch.cuda.device(dev) if on_card else _one_cpu_thread():
        x = torch.linspace(0.0, 1.0, elems, dtype=torch.float32, device=dev)
        m = torch.ones((mm_n, mm_n), dtype=torch.float32, device=dev)
        tiny = torch.ones((), dtype=torch.float32, device=dev)
        # D2H into page-locked memory, as the collect stage copies
        host = torch.empty(PROBE_ELEMS, dtype=torch.float32, pin_memory=on_card)
        head = x[:PROBE_ELEMS]
        # the memory and compute probes (each one kernel on a card)
        kernels = {
            "read": lambda: x.sum(),
            "write": lambda: x.fill_(0.5),
            "matmul": lambda: m @ m,
        }

        def tick():
            tiny.add_(1.0)
            done()

        def d2h():
            host.copy_(head, non_blocking=on_card)
            done()

        # warm every probe (kernel selection and allocations happen
        # here, not in the timing)
        for fn in kernels.values():
            fn()
        tick()
        d2h()

        def ticks():
            for _ in range(DISPATCH_REPS):
                tick()

        tick_s = _best_seconds(ticks) / DISPATCH_REPS
        d2h_s = _best_seconds(d2h)
        if on_card:
            # the card's own time of each kernel; nothing to subtract
            secs = {k: _device_seconds(fn) for k, fn in kernels.items()}
            fixed_s = 0.0
        else:
            secs = {k: _best_seconds(fn) for k, fn in kernels.items()}
            # subtract the measured fixed dispatch cost so launch
            # latency doesn't masquerade as low bandwidth
            fixed_s = tick_s
        del x, m, tiny, host, head, kernels
    if on_card:
        # the probe's memory is not the flow's: the matmul's cuBLAS
        # workspace (32 MiB on an H100, kept by PyTorch for the stream)
        # goes, the peak the probe set is forgotten, and its blocks go
        # back to the card
        clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear_workspaces is not None:
            clear_workspaces()
        torch.cuda.synchronize(dev)
        if torch.cuda.max_memory_allocated(dev) > peak_before:
            torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.empty_cache()

    def rate(amount: float, s: float) -> float:
        return amount / max(s - fixed_s, 1e-9) / 1e9

    nbytes = elems * 4
    ici_gbps, ici_how = ici_probe(dev)
    logger.info("ici probe: %s", ici_how)
    profile = MachineProfile(
        backend=backend,
        device_kind=kind,
        hbm_read_gbps=round(rate(nbytes, secs["read"]), 3),
        hbm_write_gbps=round(rate(nbytes, secs["write"]), 3),
        flops_gflops=round(rate(2.0 * mm_n ** 3, secs["matmul"]), 3),
        dispatch_overhead_us=round(tick_s * 1e6, 3),
        d2h_gbps=round(PROBE_ELEMS * 4 / d2h_s / 1e9, 3),
        ici_gbps=round(ici_gbps, 3) if ici_gbps else None,
        decode_rows_per_sec=_probe_decode_rate(),
        probe_ms=round((time.perf_counter() - t_start) * 1000.0, 1),
    )
    logger.info("machine profile calibrated: %s", profile.to_dict())
    return profile


@contextlib.contextmanager
def _one_cpu_thread():
    """The CPU probes run on one intra-op thread: on a shared host a
    parallel region waits for its slowest thread, and a thread that the
    scheduler parks for a time slice turns a 20 µs sum into 30 ms."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- persistence ------------------------------------------------------------
def _matches(profile: MachineProfile, backend: str, kind: str) -> bool:
    return (
        profile.version == PROFILE_VERSION
        and profile.backend == backend
        and profile.device_kind == kind
    )


def load_profile(path: str) -> Optional[MachineProfile]:
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        return MachineProfile.from_dict(obj) if isinstance(obj, dict) else None
    except (OSError, ValueError):
        return None


def save_profile(profile: MachineProfile, path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(profile.to_dict(), f, separators=(",", ":"))
    os.replace(tmp, path)


def _objstore_client(url: str):
    from ..compile.aotcache import _parse_objstore_url
    from ..serve.objectstore import ObjectStoreClient

    endpoint, bucket, prefix = _parse_objstore_url(url)
    token = os.environ.get("DATAX_OBJSTORE_TOKEN")
    return ObjectStoreClient(endpoint, bucket, token=token), prefix


def _share_key(prefix: str, backend: str, kind: str) -> str:
    safe_kind = "".join(
        c if c.isalnum() or c in "._-" else "_" for c in kind
    )
    key = f"machineprofile-{backend}-{safe_kind}.json"
    return f"{prefix}/{key}" if prefix else key


def pull_shared(url: str, backend: str, kind: str) -> Optional[MachineProfile]:
    """Fetch a peer's profile for this backend+device from the shared
    store; best-effort (a dead store just means we calibrate)."""
    try:
        client, prefix = _objstore_client(url)
        data = client.get(_share_key(prefix, backend, kind))
        if not data:
            return None
        obj = json.loads(data.decode("utf-8"))
        return MachineProfile.from_dict(obj) if isinstance(obj, dict) else None
    except Exception as e:  # noqa: BLE001 — shared layer is best-effort
        logger.warning("machine-profile pull failed: %s", e)
        return None


def push_shared(url: str, profile: MachineProfile) -> bool:
    """Publish this host's profile so identical peers skip calibration."""
    try:
        client, prefix = _objstore_client(url)
        client.put(
            _share_key(prefix, profile.backend, profile.device_kind),
            json.dumps(profile.to_dict(), separators=(",", ":")).encode(),
        )
        return True
    except Exception as e:  # noqa: BLE001 — best-effort
        logger.warning("machine-profile push failed: %s", e)
        return False


# -- the once-per-process-and-device entry point ----------------------------
_cache_lock = threading.Lock()
_cached: Dict[str, MachineProfile] = {}  # str(device) -> its profile


def clear_cache() -> None:
    """Forget every process-cached profile: the next ``get_profile``
    reads the files and the store, or calibrates."""
    with _cache_lock:
        _cached.clear()


def get_profile(
    cache_file: Optional[str] = None,
    share_url: Optional[str] = None,
    force: bool = False,
    device="cuda",
) -> MachineProfile:
    """The profile of ``device``: process-cached, then the local
    ``cache_file``, then the shared store, then live calibration
    (whose result is persisted back through both layers). ``force``
    skips every cache."""
    dev, backend, kind = device_identity(device)
    key = str(dev)
    with _cache_lock:
        if not force:
            cached = _cached.get(key)
            if cached is not None and _matches(cached, backend, kind):
                return cached
            if cache_file:
                p = load_profile(cache_file)
                if p is not None and _matches(p, backend, kind):
                    _cached[key] = p
                    return p
            if share_url:
                p = pull_shared(share_url, backend, kind)
                if p is not None and _matches(p, backend, kind):
                    _cached[key] = p
                    if cache_file:
                        save_profile(p, cache_file)
                    return p
        profile = calibrate(dev)
        _cached[key] = profile
        if cache_file:
            try:
                save_profile(profile, cache_file)
            except OSError as e:
                logger.warning("machine-profile save failed: %s", e)
        if share_url:
            push_shared(share_url, profile)
        return profile
