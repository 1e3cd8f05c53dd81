"""The port's step guards (``process.debug.nans``/``tracerleaks``,
``runtime/debugguard.py``) against the JAX package's
``jax.debug_nans``/``jax.checking_leaks`` arming: the counterpart of
``tests/test_udfcheck.py::TestDebugSanitizers``.

- Off, a NaN-making UDF (``nanny``: log(x - 100)) runs silently in both
  packages; armed with ``nans``, both raise ``FloatingPointError``.
- ``tracerleaks``: a UDF that keeps its input past the call raises a
  ``[Ll]eak`` error in both packages, and runs silently unarmed.
- A LiveQuery kernel created with ``debug=True`` raises on ``nanny``.
- The anomaly query armed with every guard and the buffer sanitizer
  gives rows equal to the unarmed run and to the JAX package's (floats
  within rtol 1e-6), and the guards' check count is what their design
  says: one host sync per UDF call and per view that computes a float.
- Where the NaN guard points: a NaN carried from the input is left to
  the view that computes from it, and a view-computed NaN names the
  view and the column.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu.udf.api import JaxUdf
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.runtime.debugguard import TensorLeakError
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.udf.api import TorchUdf

torch.set_num_threads(2)

SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
        {"name": "temperature", "type": "double", "nullable": False,
         "metadata": {}},
    ],
})
BASE_MS = 1_700_000_000_000
NANNY_Q = (
    "--DataXQuery--\n"
    "T = SELECT nanny(temperature) AS n FROM DataXProcessedInput"
)
LEAK_Q = (
    "--DataXQuery--\n"
    "T = SELECT leaker(temperature) AS v FROM DataXProcessedInput"
)
ANOMALY_Q = (
    "--DataXQuery--\n"
    "Scored = SELECT deviceId, temperature, "
    "anomalyscore(temperature, deviceId) AS score FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "T = SELECT deviceId, score FROM Scored WHERE score > 0.5\n"
)
ALL_GUARDS = {
    "datax.job.process.debug.nans": "true",
    "datax.job.process.debug.tracerleaks": "true",
    "datax.job.process.debug.buffersanitizer": "true",
}

J_NANNY = JaxUdf(
    "nanny", lambda x: jnp.log(x.astype(jnp.float32) - 100.0), out_type="double"
)
T_NANNY = TorchUdf(
    "nanny", lambda x: torch.log(x.to(torch.float32) - 100.0), out_type="double"
)
LEAKED = []


def _j_leak(x):
    LEAKED.append(x)
    return x.astype(jnp.float32) * 1.0


def _t_leak(x):
    LEAKED.append(x)
    return x.to(torch.float32) * 1.0


def _conf(transform, conf_extra):
    conf = {
        "datax.job.name": "DebugGuards",
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": transform,
        "datax.job.process.projection": "Raw.*",
        "datax.job.process.jar.udf.anomalyscore.class":
            "data_accelerator_tpu_torch.udf.samples:anomalyscore",
    }
    conf.update(conf_extra or {})
    return conf


def make_proc(transform, udfs=None, conf_extra=None, capacity=64):
    return FlowProcessor(
        SettingDictionary(_conf(transform, conf_extra)), udfs=udfs,
        batch_capacity=capacity, output_datasets=["T"], device="cpu",
    )


def make_jproc(transform, udfs=None, conf_extra=None, capacity=64):
    conf = _conf(transform, conf_extra)
    conf["datax.job.process.jar.udf.anomalyscore.class"] = (
        "data_accelerator_tpu.udf.samples:anomalyscore"
    )
    return JFlowProcessor(
        JSettingDictionary(conf), udfs=udfs, batch_capacity=capacity,
        output_datasets=["T"],
    )


def feed(proc, device_ids, temps, batch_time_ms=BASE_MS):
    cap = proc.batch_capacity
    cols = {
        "deviceId": np.zeros(cap, np.int32),
        "temperature": np.zeros(cap, np.float32),
    }
    n = len(device_ids)
    cols["deviceId"][:n] = device_ids
    cols["temperature"][:n] = temps
    return proc.process_batch(proc.encode_columns(cols, n), batch_time_ms)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_debug_nans_off_is_silent(pkg):
    if pkg == "jax":
        proc = make_jproc(NANNY_Q, udfs={"nanny": J_NANNY})
    else:
        proc = make_proc(NANNY_Q, udfs={"nanny": T_NANNY})
    assert not proc.debug_nans
    datasets, _ = feed(proc, [1], [5.0])  # log(-95) -> NaN, silently
    assert np.isnan(datasets["T"][0]["n"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_debug_nans_raises_loudly(pkg):
    nans = {"datax.job.process.debug.nans": "true"}
    if pkg == "jax":
        proc = make_jproc(NANNY_Q, udfs={"nanny": J_NANNY}, conf_extra=nans)
    else:
        proc = make_proc(NANNY_Q, udfs={"nanny": T_NANNY}, conf_extra=nans)
    assert proc.debug_nans
    with pytest.raises(FloatingPointError):
        feed(proc, [1], [5.0])


def test_nan_error_names_the_udf_and_its_view():
    proc = make_proc(
        NANNY_Q, udfs={"nanny": T_NANNY},
        conf_extra={"datax.job.process.debug.nans": "true"},
    )
    with pytest.raises(FloatingPointError, match="UDF 'nanny' in view 'T'"):
        feed(proc, [1], [5.0])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_debug_tracer_leaks_raises_loudly(pkg):
    leaks = {"datax.job.process.debug.tracerleaks": "true"}
    LEAKED.clear()
    if pkg == "jax":
        udfs = {"leaker": JaxUdf("leaker", _j_leak, out_type="double")}
        proc = make_jproc(LEAK_Q, udfs=udfs, conf_extra=leaks)
        proc2 = make_jproc(LEAK_Q, udfs=udfs)
    else:
        udfs = {"leaker": TorchUdf("leaker", _t_leak, out_type="double")}
        proc = make_proc(LEAK_Q, udfs=udfs, conf_extra=leaks)
        proc2 = make_proc(LEAK_Q, udfs=udfs)
    assert proc.debug_tracer_leaks
    with pytest.raises(Exception, match="[Ll]eak"):
        feed(proc, [1], [5.0])
    LEAKED.clear()
    # the same impure UDF sails through silently without the flag
    datasets, _ = feed(proc2, [1], [5.0])
    assert datasets["T"][0]["v"] == 5.0
    LEAKED.clear()


def test_leak_error_is_typed_and_a_pure_udf_is_silent():
    leaks = {"datax.job.process.debug.tracerleaks": "true"}
    LEAKED.clear()
    leaker = TorchUdf("leaker", _t_leak, out_type="double")
    with pytest.raises(TensorLeakError, match="UDF 'leaker' in view 'T'"):
        feed(make_proc(LEAK_Q, udfs={"leaker": leaker}, conf_extra=leaks),
             [1], [5.0])
    LEAKED.clear()
    # returning the input itself is no leak: the output is the step's
    same = TorchUdf("leaker", lambda x: x, out_type="double")
    datasets, _ = feed(
        make_proc(LEAK_Q, udfs={"leaker": same}, conf_extra=leaks), [1], [5.0]
    )
    assert datasets["T"][0]["v"] == 5.0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_livequery_kernel_debug_flag(pkg):
    rows = [{"deviceId": 1, "temperature": 5.0}]
    if pkg == "jax":
        from data_accelerator_tpu.serve.livequery import KernelService

        svc, nanny = KernelService(), J_NANNY
    else:
        from data_accelerator_tpu_torch.serve.livequery import KernelService

        svc, nanny = KernelService(device="cpu"), T_NANNY
    kid = svc.create_kernel(
        "DbgFlow", SCHEMA, sample_rows=rows, udfs={"nanny": nanny}, debug=True,
    )
    with pytest.raises(FloatingPointError):
        svc.execute(
            kid, "S = SELECT nanny(temperature) AS n FROM DataXProcessedInput",
        )
    # unarmed, the same query returns its NaN row
    kid2 = svc.create_kernel(
        "DbgFlow", SCHEMA, sample_rows=rows, udfs={"nanny": nanny},
    )
    out = svc.execute(
        kid2, "S = SELECT nanny(temperature) AS n FROM DataXProcessedInput",
    )
    assert len(out["result"]) == 1


def _anomaly_batches(seed, n_batches=3, cap=256):
    rs = np.random.RandomState(seed)
    for b in range(n_batches):
        n = int(rs.randint(cap // 2, cap + 1))
        yield (
            rs.randint(0, 50, n).astype(np.int32),
            rs.uniform(-40.0, 120.0, n).astype(np.float32),
            BASE_MS + 1000 * b,
        )


def test_armed_anomaly_query_rows_equal_unarmed_and_jax():
    armed = make_proc(ANOMALY_Q, conf_extra=ALL_GUARDS, capacity=256)
    plain = make_proc(ANOMALY_Q, capacity=256)
    jproc = make_jproc(ANOMALY_Q, capacity=256)
    assert armed.step_guard is not None and armed.buffer_sanitizer is not None
    assert plain.step_guard is None and plain.buffer_sanitizer is None
    for ids, temps, t in _anomaly_batches(7):
        got, metrics = feed(armed, ids, temps, t)
        want, _ = feed(plain, ids, temps, t)
        jwant, _ = feed(jproc, ids, temps, t)
        assert got["T"] == want["T"]
        assert len(got["T"]) == len(jwant["T"]) > 0
        for a, b in zip(got["T"], jwant["T"]):
            assert a["deviceId"] == b["deviceId"]
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-6)
        assert "Sanitizer_PoisonHit_Count" not in metrics
        # one UDF call and one view computing a float (Scored.score; T
        # carries it): two host syncs a batch, none unarmed
        assert armed.step_guard.take_checks() == 2


def test_nan_carried_from_input_is_left_to_the_computing_view():
    """A NaN the source sent passes the views that carry it, and the
    guard fires at the UDF that computes from it, naming the view."""
    proc = make_proc(
        ANOMALY_Q, conf_extra={"datax.job.process.debug.nans": "true"},
    )
    with pytest.raises(
        FloatingPointError, match="UDF 'anomalyscore' in view 'Scored'"
    ):
        feed(proc, [1, 2], [float("nan"), 3.0])


def test_view_computed_nan_names_view_and_column():
    q = (
        "--DataXQuery--\n"
        "T = SELECT deviceId, LOG(temperature - 100.0) AS lg "
        "FROM DataXProcessedInput\n"
    )
    proc = make_proc(q, conf_extra={"datax.job.process.debug.nans": "true"})
    with pytest.raises(FloatingPointError, match=r"view 'T', column\(s\) \['lg'\]"):
        feed(proc, [1], [5.0])
    # a NaN only in the padding rows (invalid) is no output, and passes
    ok = make_proc(
        "--DataXQuery--\n"
        "T = SELECT deviceId, LOG(temperature - 1.0) AS lg "
        "FROM DataXProcessedInput\n",
        conf_extra={"datax.job.process.debug.nans": "true"},
    )
    datasets, _ = feed(ok, [1], [5.0])
    np.testing.assert_allclose(datasets["T"][0]["lg"], np.log(4.0), rtol=1e-6)
