"""The port's scenario runner and JobRunner probe (``serve/scenario.py``,
``serve/jobrunner.py``, ``serve/scenarios.py``) beside the JAX
package's: twins of ``tests/test_scenarios_live.py``'s three tests,
each run against both packages' REST APIs on the CPU, and of
``tests/test_scheduler_jobrunner.py``'s two JobRunner tests.

The port's API runs its jobs as ``python -m
data_accelerator_tpu_torch.runtime.host ... device=cpu`` children. A
scenario passes in one package exactly when it passes in the other, with
the same steps in the same order.
"""

import pytest

from data_accelerator_tpu.obs.metrics import MetricLogger as JMetricLogger
from data_accelerator_tpu.obs.metrics import MetricStore as JMetricStore
from data_accelerator_tpu.serve import flowservice as jflowservice
from data_accelerator_tpu.serve import restapi as jrestapi
from data_accelerator_tpu.serve import storage as jstorage
from data_accelerator_tpu.serve.jobrunner import JobRunner as JJobRunner
from data_accelerator_tpu.serve.scenario import Scenario as JScenario
from data_accelerator_tpu.serve.scenarios import default_suite as jdefault_suite
from data_accelerator_tpu.serve.scenarios import save_and_deploy as jsave_and_deploy
from data_accelerator_tpu.serve.scenarios import schema_and_query as jschema_and_query
from data_accelerator_tpu_torch.obs.metrics import MetricLogger, MetricStore
from data_accelerator_tpu_torch.serve import flowservice, restapi, storage
from data_accelerator_tpu_torch.serve.jobrunner import JobRunner
from data_accelerator_tpu_torch.serve.scenario import Scenario
from data_accelerator_tpu_torch.serve.scenarios import (
    default_suite,
    save_and_deploy,
    schema_and_query,
)


def _serve(tmp_path, pkg):
    fs, ra, st = {"jax": (jflowservice, jrestapi, jstorage),
                  "torch": (flowservice, restapi, storage)}[pkg]
    dev = {"device": "cpu"} if pkg == "torch" else {}
    ops = fs.FlowOperation(
        st.LocalDesignTimeStorage(str(tmp_path / pkg / "design")),
        st.LocalRuntimeStorage(str(tmp_path / pkg / "runtime")),
        **dev,
    )
    svc = ra.DataXApiService(ra.DataXApi(ops, **dev), port=0)
    svc.start()
    return svc


@pytest.fixture()
def live_apis(tmp_path):
    """Both packages' REST APIs, each on its own port and storage."""
    svcs = {}
    try:
        for pkg in ("jax", "torch"):
            svcs[pkg] = _serve(tmp_path, pkg)
        yield {pkg: f"http://127.0.0.1:{svc.port}" for pkg, svc in svcs.items()}
    finally:
        for svc in svcs.values():
            svc.stop()


def _steps(result):
    return [(s.name, s.success) for s in result.steps]


def test_schema_and_query_scenario_passes(live_apis):
    got = schema_and_query(live_apis["torch"]).run()
    want = jschema_and_query(live_apis["jax"]).run()
    assert got.success, (got.failed_step, [s.error for s in got.steps if not s.success])
    assert [s.name for s in got.steps] == [
        "init_context", "infer_schema", "create_kernel",
        "execute_query", "recycle_kernel",
    ]
    assert _steps(got) == _steps(want)


def test_save_and_deploy_scenario_passes(live_apis):
    got = save_and_deploy(live_apis["torch"], batches=1).run()
    assert got.success, (
        got.failed_step, [s.error for s in got.steps if not s.success],
    )
    want = jsave_and_deploy(live_apis["jax"], batches=1).run()
    assert _steps(got) == _steps(want)


def test_jobrunner_runs_default_suite(live_apis):
    store = MetricStore()
    runner = JobRunner(default_suite(live_apis["torch"]),
                       metric_logger=MetricLogger("DATAX-JobRunner", store=store))
    results = runner.run_once()
    assert [r.success for r in results] == [True, True], [
        (r.failed_step, [s.error for s in r.steps if not s.success]) for r in results]
    assert {h["scenario"] for h in runner.history} == {
        "SaveAndDeploy", "SchemaAndQuery"
    }
    for name in ("SaveAndDeploy", "SchemaAndQuery"):
        assert store.points(f"DATAX-JobRunner:{name}")[0]["val"] == 1
        assert store.points(f"DATAX-JobRunner:{name}-ElapsedMs")[0]["val"] > 0
    jrunner = JJobRunner(jdefault_suite(live_apis["jax"]))
    jresults = jrunner.run_once()
    assert [_steps(r) for r in results] == [_steps(r) for r in jresults]


def _two_scenarios(scenario_cls):
    ok = scenario_cls("deploy")
    ok.step(lambda ctx: ctx.update(x=1))
    bad = scenario_cls("query")

    def failing(ctx):
        raise AssertionError("kernel down")

    bad.step(failing)
    return [ok, bad]


def test_jobrunner_records_history_and_metrics():
    store, jstore = MetricStore(), JMetricStore()
    runner = JobRunner(_two_scenarios(Scenario),
                       metric_logger=MetricLogger("DATAX-JobRunner", store=store))
    jrunner = JJobRunner(_two_scenarios(JScenario),
                         metric_logger=JMetricLogger("DATAX-JobRunner", store=jstore))
    results = runner.run_once()
    jresults = jrunner.run_once()
    assert [r.success for r in results] == [r.success for r in jresults] == [True, False]
    keys = ("scenario", "success", "failedStep")
    assert [[h[k] for k in keys] for h in runner.history] == [
        [h[k] for k in keys] for h in jrunner.history]
    assert runner.history[1]["failedStep"] == "failing"
    for name, val in (("deploy", 1), ("query", 0)):
        assert store.points(f"DATAX-JobRunner:{name}")[0]["val"] == val
        assert jstore.points(f"DATAX-JobRunner:{name}")[0]["val"] == val


def test_jobrunner_history_bounded():
    lens = []
    for runner_cls, scenario_cls in ((JobRunner, Scenario), (JJobRunner, JScenario)):
        sc = scenario_cls("s")
        sc.step(lambda ctx: None)
        runner = runner_cls([sc], max_history=3)
        for _ in range(5):
            runner.run_once()
        lens.append(len(runner.history))
    assert lens == [3, 3]
