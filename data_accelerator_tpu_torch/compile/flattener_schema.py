"""Default flattener schema: flow job-config JSON -> ``datax.job.*`` keys.

Semantically equivalent to the reference's default flattener schema
(DataX.Config.Local/Resources/flattenerConfig.json) so flow templates
written for the reference flatten to the same runtime keys. Expressed as
Python data with the repeated per-output mapping defined once.

Copy of the JAX package's ``compile/flattener_schema.py``, unchanged:
the conf tier (``analysis/confcheck.py``) enumerates the keys this
template produces.
"""

_STR_LIST = lambda ns: {"type": "stringList", "namespace": ns}  # noqa: E731

_OUTPUT_FIELDS = {
    "blob": {
        "type": "object",
        "namespace": "blob",
        "fields": {
            "groupEvaluation": "groupevaluation",
            "compressionType": {
                "type": "excludeDefaultValue",
                "namespace": "compressiontype",
                "defaultValue": "gzip",
            },
            "format": {
                "type": "excludeDefaultValue",
                "namespace": "format",
                "defaultValue": "json",
            },
            "groups": {
                "type": "map",
                "namespace": "group",
                "fields": {"folder": "folder"},
            },
        },
    },
    "eventhub": {
        "type": "object",
        "namespace": "eventhub",
        "fields": {
            "connectionStringRef": "connectionstring",
            "compressionType": {
                "type": "excludeDefaultValue",
                "namespace": "compressiontype",
                "defaultValue": "gzip",
            },
            "format": {
                "type": "excludeDefaultValue",
                "namespace": "format",
                "defaultValue": "json",
            },
            "appendProperties": {"type": "mapProps", "namespace": "appendproperty"},
        },
    },
    "cosmosdb": {
        "type": "object",
        "namespace": "cosmosdb",
        "fields": {
            "connectionStringRef": "connectionstring",
            "database": "database",
            "collection": "collection",
        },
    },
    "httppost": {
        "type": "object",
        "namespace": "httppost",
        "fields": {
            "endpoint": "endpoint",
            "filter": "filter",
            "appendHeaders": {"type": "mapProps", "namespace": "header"},
        },
    },
    # TPU-native additions (no reference analog): local file + console sinks
    "file": {
        "type": "object",
        "namespace": "file",
        "fields": {
            "path": "path",
            "format": {
                "type": "excludeDefaultValue",
                "namespace": "format",
                "defaultValue": "json",
            },
            "compressionType": {
                "type": "excludeDefaultValue",
                "namespace": "compressiontype",
                "defaultValue": "none",
            },
        },
    },
    "console": {
        "type": "object",
        "namespace": "console",
        "fields": {"maxRows": "maxrows"},
    },
    "externalfn": {
        "type": "object",
        "namespace": "externalfn",
        "fields": {
            "serviceEndpoint": "serviceendpoint",
            "api": "api",
            "code": "code",
            "methodType": "methodtype",
        },
    },
    "metric": "metric",
}

_JAR_FN = lambda ns: {  # noqa: E731
    "type": "array",
    "namespace": ns,
    "element": {
        "type": "scopedObject",
        "namespaceField": "name",
        "fields": {
            "class": "class",
            "path": "path",
            "libs": _STR_LIST("libs"),
        },
    },
}

DEFAULT_FLATTENER_SCHEMA = {
    "type": "object",
    "namespace": "datax.job",
    "fields": {
        "name": "name",
        "input": {
            "type": "object",
            "namespace": "input.default",
            "fields": {
                "inputType": "inputtype",
                "blobSchemaFile": "blobschemafile",
                "sourceIdRegex": "sourceidregex",
                "blobPathRegex": "blobpathregex",
                "fileTimeRegex": "filetimeregex",
                "fileTimeFormat": "filetimeformat",
                "eventhub": {
                    "type": "object",
                    "namespace": "eventhub",
                    "fields": {
                        "connectionString": "connectionstring",
                        "consumerGroup": "consumergroup",
                        "checkpointDir": "checkpointdir",
                        "checkpointInterval": "checkpointinterval",
                        "maxRate": "maxrate",
                        "flushExistingCheckpoints": "flushexistingcheckpoints",
                    },
                },
                "kafka": {
                    "type": "object",
                    "namespace": "kafka",
                    "fields": {
                        "bootstrapServers": "bootstrapservers",
                        "topics": "topics",
                        "consumerGroup": "consumergroup",
                        "checkpointDir": "checkpointdir",
                        "maxRate": "maxrate",
                    },
                },
                "streaming": {
                    "type": "object",
                    "namespace": "streaming",
                    "fields": {
                        "checkpointDir": "checkpointdir",
                        "intervalInSeconds": "intervalinseconds",
                        "maxBatchSize": "maxbatchsize",
                    },
                },
                "sources": {
                    "type": "map",
                    "namespace": "source",
                    "fields": {"target": "target", "catalogPrefix": "catalogprefix"},
                },
                "referenceData": {
                    "type": "array",
                    "namespace": "referencedata",
                    "element": {
                        "type": "scopedObject",
                        "namespaceField": "name",
                        "fields": {
                            "path": "path",
                            "format": "format",
                            "header": "header",
                            "delimiter": "delimiter",
                        },
                    },
                },
            },
        },
        "process": {
            "type": "object",
            "namespace": "process",
            "fields": {
                "metric": {
                    "type": "object",
                    "namespace": "metric",
                    "fields": {
                        "eventhub": "eventhub",
                        "httppost": "httppost",
                        "redis": "redis",
                    },
                },
                "projections": _STR_LIST("projection"),
                "transform": "transform",
                "timestampColumn": "timestampcolumn",
                "watermark": "watermark",
                "timeWindows": {
                    "type": "array",
                    "namespace": "timewindow",
                    "element": {
                        "type": "scopedObject",
                        "namespaceField": "name",
                        "fields": {"windowDuration": "windowduration"},
                    },
                },
                "jarUDFs": _JAR_FN("jar.udf"),
                "jarUDAFs": _JAR_FN("jar.udaf"),
                "accumulationTables": {
                    "type": "array",
                    "namespace": "statetable",
                    "element": {
                        "type": "scopedObject",
                        "namespaceField": "name",
                        "fields": {"schema": "schema", "location": "location"},
                    },
                },
                "azureFunctions": {
                    "type": "array",
                    "namespace": "azurefunction",
                    "element": {
                        "type": "scopedObject",
                        "namespaceField": "name",
                        "fields": {
                            "serviceEndpoint": "serviceendpoint",
                            "api": "api",
                            "code": "code",
                            "methodType": "methodtype",
                            "params": _STR_LIST("params"),
                        },
                    },
                },
                "appendEventTags": {"type": "mapProps", "namespace": "appendproperty"},
            },
        },
        "output": {
            "type": "scopedObject",
            "namespace": "output",
            "namespaceField": "name",
            "fields": _OUTPUT_FIELDS,
        },
        "outputs": {
            "type": "array",
            "element": {
                "type": "scopedObject",
                "namespace": "output",
                "namespaceField": "name",
                "fields": _OUTPUT_FIELDS,
            },
        },
    },
}
