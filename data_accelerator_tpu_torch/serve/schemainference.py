"""Schema inference: sampled JSON events -> Spark-style schema JSON.

reference: DataX.Flow/DataX.Flow.SchemaInference —
``SchemaInferenceManager.GetInputSchema`` samples N seconds of live
events from the message bus ({Eventhub,Kafka,Blob}/*MessageBus.cs:43)
and ``Engine.GetSchema``/``SchemaGenerator`` merges the JSON shapes into
one schema document (Engine.cs:23-65) plus a sample-data blob consumed
by LiveQuery kernel init (KernelService.cs:104-130).

The schema format matches the engine's input contract
(core/schema.py parse of ``{"type":"struct","fields":[...]}``).

A whole copy of the JAX package's ``serve/schemainference.py``: it is
framework-free. ``sample_events`` polls any of the port's
``runtime/sources.py`` ``StreamingSource``s, and its ``max_events=1000``
sets the designer's sample size.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# -- type lattice ------------------------------------------------------------
# merge order: conflicting scalars widen long->double->string
_WIDEN = {
    ("long", "double"): "double",
    ("double", "long"): "double",
}


def _json_type(value: Any) -> Tuple[str, Any]:
    """Returns (type-name or 'struct'/'array', nested payload)."""
    if isinstance(value, bool):
        return "boolean", None
    if isinstance(value, int):
        return "long", None
    if isinstance(value, float):
        return "double", None
    if isinstance(value, str):
        return "string", None
    if isinstance(value, dict):
        return "struct", value
    if isinstance(value, list):
        return "array", value
    return "null", None  # None -> type decided by other samples


# distinct scalar values tracked per field before the set is declared
# high-cardinality and dropped; surviving sets become ``allowedValues``
# metadata — the sampled-cardinality surface the device-plan analyzer's
# DX200/DX202 capacity lints and utils/datagen.py consume
_MAX_SAMPLED_VALUES = 64


@dataclass
class _FieldAcc:
    """Accumulated evidence for one field across samples."""

    type: str = "null"
    struct: Optional["_StructAcc"] = None
    element: Optional["_FieldAcc"] = None
    seen: int = 0
    nullable: bool = False
    values: set = field(default_factory=set)
    values_overflow: bool = False

    def observe(self, value: Any) -> None:
        self.seen += 1
        t, payload = _json_type(value)
        if t == "null":
            self.nullable = True
            return
        if t == "struct":
            if self.struct is None:
                self.struct = _StructAcc()
            self.struct.observe(payload)
            self.type = "struct" if self.type in ("null", "struct") else "string"
            return
        if t == "array":
            if self.element is None:
                self.element = _FieldAcc()
            for item in payload:
                self.element.observe(item)
            self.type = "array" if self.type in ("null", "array") else "string"
            return
        if t in ("string", "long", "boolean") and not self.values_overflow:
            self.values.add(value)
            if len(self.values) > _MAX_SAMPLED_VALUES:
                self.values_overflow = True
                self.values.clear()
        if self.type == "null":
            self.type = t
        elif self.type != t:
            self.type = _WIDEN.get((self.type, t), "string")

    def sampled_metadata(self) -> dict:
        """``allowedValues`` for a low-cardinality scalar field whose
        samples all share the final type (a widened/mixed field has no
        meaningful value set)."""
        if self.values_overflow or not self.values:
            return {}
        homogeneous = {
            "string": lambda v: isinstance(v, str),
            "boolean": lambda v: isinstance(v, bool),
            "long": lambda v: isinstance(v, int) and not isinstance(v, bool),
        }.get(self.type)
        if homogeneous is None or not all(map(homogeneous, self.values)):
            return {}
        return {"allowedValues": sorted(self.values)}

    def to_schema_type(self) -> Any:
        if self.type == "struct" and self.struct is not None:
            return self.struct.to_schema()
        if self.type == "array":
            elem = self.element.to_schema_type() if self.element else "string"
            return {
                "type": "array",
                "elementType": elem,
                "containsNull": True,
            }
        return self.type if self.type != "null" else "string"


@dataclass
class _StructAcc:
    fields: Dict[str, _FieldAcc] = field(default_factory=dict)
    samples: int = 0

    def observe(self, obj: dict) -> None:
        self.samples += 1
        for k, v in obj.items():
            self.fields.setdefault(k, _FieldAcc()).observe(v)

    def to_schema(self) -> dict:
        out = []
        for name, acc in self.fields.items():
            out.append({
                "name": name,
                "type": acc.to_schema_type(),
                "nullable": acc.nullable or acc.seen < self.samples,
                "metadata": acc.sampled_metadata(),
            })
        return {"type": "struct", "fields": out}


def infer_schema(events: List[dict]) -> dict:
    """Merge JSON event shapes into one struct schema
    (reference: SchemaGenerator merge, Engine.cs:23-65)."""
    acc = _StructAcc()
    for e in events:
        if isinstance(e, dict):
            acc.observe(e)
    return acc.to_schema()


class SchemaInferenceManager:
    """Sample a source for N seconds, emit schema + sample blob.

    reference: SchemaInferenceManager.GetInputSchema +
    EventhubMessageBus.GetSampleEvents(seconds).
    """

    def __init__(self, runtime_storage=None):
        self.runtime = runtime_storage

    def sample_events(
        self, source, seconds: float = 5.0, max_events: int = 1000
    ) -> List[dict]:
        """Pull events from a runtime StreamingSource for ``seconds``."""
        events: List[dict] = []
        deadline = time.time() + seconds
        while time.time() < deadline and len(events) < max_events:
            rows, _offsets = source.poll(max_events - len(events))
            source.ack()
            events.extend(rows)
            if not rows:
                time.sleep(0.05)
        return events

    def get_input_schema(
        self,
        source=None,
        events: Optional[List[dict]] = None,
        flow_name: str = "",
        seconds: float = 5.0,
        max_events: int = 1000,
    ) -> dict:
        """Returns {"Schema": <schema json str>, "Samples": [...]} and, when
        runtime storage is configured, persists the sample blob for
        LiveQuery kernel init (the reference writes it to the flow's
        sample folder)."""
        if events is None:
            if source is None:
                raise ValueError("either source or events required")
            events = self.sample_events(source, seconds, max_events)
        schema = infer_schema(events)
        result = {
            "Schema": json.dumps(schema),
            "Samples": events[:max_events],
            "EventsSampled": len(events),
        }
        if self.runtime is not None and flow_name:
            self.runtime.save_file(
                f"{flow_name}/samples/sample.json",
                "\n".join(json.dumps(e) for e in events),
            )
        return result
