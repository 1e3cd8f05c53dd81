"""``chip_smoke.py``'s ``mesh_model`` phase alone, after the kernels'
build: the quickest check of the mesh model on one card.

    python3 tools/mesh_model_phase.py

Prints the build's seconds, the phase's line, its launches, and the
card's name and power limit last."""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

cs.bind_repo_tests()
t0 = time.perf_counter()
smi = cs.phase_device()
cs.phase_build()
print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
from data_accelerator_tpu_torch.udf.samples import anomalyscore  # noqa: E402

udf = anomalyscore()
print(json.dumps({"mesh_model_launches": cs.phase_mesh_model(0, smi, udf)}), flush=True)
print(smi, flush=True)
