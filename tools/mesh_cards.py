"""The mesh across real cards: the ICI probe, ``chip_smoke.py``'s mesh
phase (its real-card ways), and its generated 4-chip job on a host over
four real cards, its rows held against a single card's.

    python3 tools/mesh_cards.py        # on a host with four cards

Prints one JSON line a part, and the card's name and power limit last."""
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

cs.bind_repo_tests()
smi = cs.phase_device()
cs.phase_build()
import torch  # noqa: E402

from data_accelerator_tpu_torch.dist import make_mesh  # noqa: E402
from data_accelerator_tpu_torch.obs.calibrate import calibrate, ici_probe  # noqa: E402
from data_accelerator_tpu_torch.udf.samples import anomalyscore  # noqa: E402

print(json.dumps({"cards": torch.cuda.device_count(), "smi": smi}), flush=True)
for _ in range(2):
    print(json.dumps({"ici_probe": ici_probe("cuda:0")}), flush=True)
print(json.dumps({"calibrate_ici_gbps": calibrate("cuda:0").ici_gbps}), flush=True)
udf = anomalyscore()
t0 = time.perf_counter()
print(json.dumps({"phase_mesh_launches": cs.phase_mesh(0, smi, udf),
                  "s": time.perf_counter() - t0}), flush=True)
rs = np.random.RandomState(29)
payloads = [cs.make_json_payload(rs, cs.CAPACITY) for _ in range(4)]
with tempfile.TemporaryDirectory() as tmp:
    conf_path = cs.mesh_model_job(tmp)
    model = json.loads(next(ln for ln in conf_path.read_text().splitlines()
                            if ln.startswith("datax.job.process.mesh.model="))
                       .split("=", 1)[1])
    host, rec, drift, launches = cs.run_mesh_host(conf_path, payloads, 4,
                                                  mesh=make_mesh(4))
    rows = cs.same_counts_single_card(conf_path, rec, "four cards")
    print(json.dumps({
        "mesh_devices": [str(d) for d in host.processor.mesh.devices],
        "Mesh_ICI_Bytes": [m.get("Mesh_ICI_Bytes") for m in rec["metrics"]],
        "ratio": [m.get("Conformance_MeshIci_Ratio") for m in rec["metrics"]],
        "model_wire": model["totals"]["iciWireBytesPerBatch"],
        "census": host.processor.mesh_collectives.to_dict(), "drift": drift,
        "launches": launches, "rows": rows,
        "latency_batch_ms": [m.get("Latency-Batch") for m in rec["metrics"]]}), flush=True)
print(smi, flush=True)
