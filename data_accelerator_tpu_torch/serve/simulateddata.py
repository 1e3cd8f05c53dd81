"""Simulated-data load generator service.

reference: Services/DataX.SimulatedData/DataX.SimulatedData.DataGenService
— a standing service that synthesizes schema-driven random events plus
periodic *rule-triggering* sequences (DataGen.cs:41-54 GenerateDataRules
interleaves rulesData rows every N batches) and pumps them into the
flow's ingest bus (EventHub/IoTHub/Kafka) at a target rate
(DataGenService.cs send loop).

TPU-native stand-in: events go to the flow's SocketSource ingest port
(the DCN path) as newline JSON. Random rows come from the same
schema-driven DataGenerator the engine's local source uses; rule rows
are explicit templates (dict overlays on a random row) injected every
``rule_period_s`` so alert flows always have something to alert on —
the role rulesData plays for the demo IoT flow.

Copy of the JAX package's ``serve/simulateddata.py``, unchanged, over
the port's ``utils/datagen.py``.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Dict, List, Optional

from ..core.schema import Schema
from ..utils.datagen import DataGenerator

logger = logging.getLogger(__name__)


class SimulatedDataService:
    def __init__(
        self,
        schema: Schema,
        host: str,
        port: int,
        events_per_second: float = 1000.0,
        rule_rows: Optional[List[Dict]] = None,
        rule_period_s: float = 5.0,
        seed: Optional[int] = None,
        batch_per_send: int = 500,
    ):
        self.schema = schema
        self.addr = (host, port)
        self.rate = events_per_second
        self.rule_rows = rule_rows or []
        self.rule_period_s = rule_period_s
        self.batch_per_send = batch_per_send
        self.gen = DataGenerator(schema, seed)
        self.events_sent = 0
        self.rule_events_sent = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock = None

    # -- generation -------------------------------------------------------
    @staticmethod
    def _deep_merge(base: dict, overlay: dict) -> dict:
        """Overlay rule fields without clobbering sibling struct fields;
        dotted keys ("a.b") address nested fields directly."""
        out = dict(base)
        for k, v in overlay.items():
            if "." in k:
                head, rest = k.split(".", 1)
                out[head] = SimulatedDataService._deep_merge(
                    out.get(head) or {}, {rest: v}
                )
            elif isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = SimulatedDataService._deep_merge(out[k], v)
            else:
                out[k] = v
        return out

    def make_batch(self, n: int, now_ms: int, with_rules: bool) -> List[dict]:
        rows = self.gen.random_rows(n, now_ms=now_ms)
        if with_rules and self.rule_rows:
            # overlay each rule template on a generated row so required
            # fields stay schema-complete (GenerateRulesData analog)
            for i, template in enumerate(self.rule_rows):
                rows[i % len(rows)] = self._deep_merge(
                    rows[i % len(rows)], template
                )
            self.rule_events_sent += len(self.rule_rows)
        return rows

    # -- send loop --------------------------------------------------------
    def _connect(self):
        return socket.create_connection(self.addr, timeout=10)

    def _send(self, rows: List[dict]) -> None:
        payload = b"".join(
            json.dumps(r, default=str).encode() + b"\n" for r in rows
        )
        try:
            if self._sock is None:
                self._sock = self._connect()
            self._sock.sendall(payload)
        except OSError:
            try:
                if self._sock is not None:
                    self._sock.close()
                self._sock = self._connect()
                self._sock.sendall(payload)
            except OSError as e:
                self._sock = None
                logger.warning("simulated data send failed: %s", e)
                return
        self.events_sent += len(rows)

    def run(self, duration_s: Optional[float] = None) -> None:
        """Paced send loop at the target rate; rule rows every period."""
        start = time.time()
        last_rule = 0.0
        while not self._stop.is_set():
            t0 = time.time()
            if duration_s is not None and t0 - start >= duration_s:
                break
            with_rules = (t0 - last_rule) >= self.rule_period_s
            if with_rules:
                last_rule = t0
            n = max(1, min(self.batch_per_send, int(self.rate)))
            self._send(self.make_batch(n, int(t0 * 1000), with_rules))
            # pace to the rate: n events should take n/rate seconds
            sleep = n / self.rate - (time.time() - t0)
            if sleep > 0:
                self._stop.wait(sleep)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


def main(argv=None):
    """CLI: schema=<file> host=127.0.0.1 port=N rate=1000 [rules=<file>]"""
    import sys

    logging.basicConfig(level=logging.INFO)
    args = dict(
        a.split("=", 1) for a in (argv or sys.argv[1:]) if "=" in a
    )
    with open(args["schema"], "r", encoding="utf-8") as f:
        schema = Schema.from_spark_json(f.read())
    rule_rows = []
    if "rules" in args:
        with open(args["rules"], "r", encoding="utf-8") as f:
            rule_rows = [json.loads(x) for x in f.read().splitlines() if x.strip()]
    svc = SimulatedDataService(
        schema,
        args.get("host", "127.0.0.1"),
        int(args["port"]),
        events_per_second=float(args.get("rate", "1000")),
        rule_rows=rule_rows,
    )
    logger.info("simulated data -> %s:%s at %s ev/s", *svc.addr, svc.rate)
    try:
        svc.run(float(args["duration"]) if "duration" in args else None)
    except KeyboardInterrupt:
        svc.stop()


if __name__ == "__main__":
    main()
