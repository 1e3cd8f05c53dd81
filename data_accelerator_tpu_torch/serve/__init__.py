"""Control plane: flow lifecycle, config generation, job management.

The analog of the reference's Services/ layer (DataX.Config +
DataX.Flow.* + DataX.Gateway): design-time flow documents in, runnable
flat ``datax.job.*`` confs and managed engine jobs out.

Exports what the JAX package's ``serve/__init__.py`` does, less
``Scenario`` and ``ScenarioContext`` (``serve/scenario.py``, slice 9b).
"""

from .templating import TokenDictionary
from .storage import (
    JobRegistry,
    LocalDesignTimeStorage,
    LocalRuntimeStorage,
    ObjectDesignTimeStorage,
    ObjectRuntimeStorage,
)
from .objectstore import ObjectStoreClient, ObjectStoreServer
from .flowbuilder import FlowConfigBuilder, RuleDefinitionGenerator
from .generation import RuntimeConfigGeneration
from .jobs import (
    JobOperation,
    JobState,
    K8sJobClient,
    LocalJobClient,
    TpuJobClient,
    make_job_client,
)
from .flowservice import FlowOperation
from .schemainference import SchemaInferenceManager, infer_schema
from .sqlanalyzer import SqlAnalyzer
from .livequery import KernelService
from .restapi import DataXApi, DataXApiService

__all__ = [
    "TokenDictionary",
    "JobRegistry",
    "LocalDesignTimeStorage",
    "LocalRuntimeStorage",
    "ObjectDesignTimeStorage",
    "ObjectRuntimeStorage",
    "ObjectStoreClient",
    "ObjectStoreServer",
    "FlowConfigBuilder",
    "RuleDefinitionGenerator",
    "RuntimeConfigGeneration",
    "JobOperation",
    "JobState",
    "K8sJobClient",
    "LocalJobClient",
    "TpuJobClient",
    "make_job_client",
    "FlowOperation",
    "SchemaInferenceManager",
    "infer_schema",
    "SqlAnalyzer",
    "KernelService",
    "DataXApi",
    "DataXApiService",
]
