"""The port's ``compile/flattener.py`` against the JAX package's: both
flatteners on the same documents give equal keys and equal conf text
(``tests/test_flattener.py``'s cases, every mapping node type, and the
default flattener schema on the job template shape)."""

import pytest

from data_accelerator_tpu.compile.flattener import ConfigFlattener as JConfigFlattener
from data_accelerator_tpu.compile.flattener_schema import (
    DEFAULT_FLATTENER_SCHEMA as J_DEFAULT_SCHEMA,
)
from data_accelerator_tpu_torch.compile.flattener import ConfigFlattener
from data_accelerator_tpu_torch.compile.flattener_schema import DEFAULT_FLATTENER_SCHEMA
from data_accelerator_tpu_torch.core.config import parse_conf_lines

from test_flattener import DOC, SCHEMA


def _home_automation_doc() -> dict:
    """``test_flattener.py``'s job template shape, with values a flat
    conf can hold (strings and a bool)."""
    return {
        "name": "HomeAutomationLocal",
        "input": {
            "eventhub": {"maxRate": "100"},
            "streaming": {"intervalInSeconds": "2"},
            "blobSchemaFile": "schema.json",
            "referenceData": [{"name": "myDevicesRefdata", "path": "/app/devices.csv",
                               "format": "csv", "header": True, "delimiter": ","}],
        },
        "process": {
            "metric": {"httppost": "http://localhost:2020/api/data/upload"},
            "timestampColumn": "eventTimeStamp", "watermark": "0 second",
            "transform": "ha.transform",
            "projections": ["p1.projection", "p2.projection"],
            "timeWindows": [{"name": "DataXProcessedInput_5minutes",
                             "windowDuration": "5 minutes"}],
            "jarUDFs": [{"name": "whoOpened", "class": "datax.sample.udf.UdfHelloWorld",
                         "path": "/bin/samples.jar", "libs": []}],
            "accumulationTables": [{"name": "acc_t", "schema": "deviceId long",
                                    "location": "/st"}],
        },
        "outputs": [
            {"name": "Metrics", "metric": ""},
            {"name": "myBlob", "blob": {"compressionType": "gzip",
                                        "groups": {"main": {"folder": "/out"}}}},
        ],
    }


CASES = {
    "all_node_types": (SCHEMA, DOC),
    "non_default_value": (SCHEMA, {"defaulted": "none"}),
    "empty_document": (SCHEMA, {}),
    "home_automation": (None, _home_automation_doc()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flatten_equals_the_reference(case):
    schema, doc = CASES[case]
    jschema = J_DEFAULT_SCHEMA if schema is None else schema
    tschema = DEFAULT_FLATTENER_SCHEMA if schema is None else schema
    want = JConfigFlattener(jschema).flatten(doc)
    got = ConfigFlattener(tschema).flatten(doc)
    assert got == want
    assert ConfigFlattener(tschema).flatten_to_conf(doc) == \
        JConfigFlattener(jschema).flatten_to_conf(doc)


def test_default_schema_is_the_references():
    assert DEFAULT_FLATTENER_SCHEMA == J_DEFAULT_SCHEMA


def test_flatten_to_conf_round_trips_through_the_ports_parser():
    conf_text = ConfigFlattener(SCHEMA).flatten_to_conf(DOC)
    assert parse_conf_lines(conf_text.split("\n")) == ConfigFlattener(SCHEMA).flatten(DOC)
