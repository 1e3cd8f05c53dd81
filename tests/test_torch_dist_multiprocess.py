"""The twin of ``tests/test_dist_multiprocess.py`` for the port: two OS
processes, each a host with a ``HostIngestPlan`` over a mesh of 2
virtual CPU shards, each ingesting only its own partitions and rows,
joined by a ``torch.distributed`` gloo group over TCP. Each gets the
same global sum and max, which include the other process's rows.

Run as a script, this file is one worker: ``python
tests/test_torch_dist_multiprocess.py <rank> <port>``.
"""

import json
import os
import socket
import subprocess
import sys

ROWS_PER_SHARD = 2
SHARDS = 2
HOSTS = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(rank: int, port: str) -> dict:
    """One host: its plan, its rows, the group's all-reduces."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from data_accelerator_tpu_torch.dist import HostIngestPlan, make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=HOSTS, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(SHARDS, devices=("cpu",) * SHARDS)
        cap = HOSTS * SHARDS * ROWS_PER_SHARD
        # rank and world size come from the group
        plan = HostIngestPlan(mesh, global_capacity=cap, n_partitions=4, max_rate=8000)
        n_rows = plan.local_capacity
        ids = np.array([rank * 100 + i for i in range(n_rows)], np.int32)
        temps = np.full(n_rows, 10.0 * (rank + 1), np.float32)
        batch = plan.make_global({"deviceId": ids, "temperature": temps},
                                 np.ones(n_rows, bool))
        s = sum(torch.where(sh.valid, sh.cols["temperature"], 0.0).sum()
                for sh in batch.shards)
        mx = max(torch.where(sh.valid, sh.cols["deviceId"], -1).max()
                 for sh in batch.shards)
        s = batch.all_reduce(torch.tensor([float(s)]), "sum")
        mx = batch.all_reduce(torch.tensor([int(mx)]), "max")
        return {
            "pid": rank, "rows_per_host": n_rows, "partitions": plan.partitions,
            "rows": [plan.rows.start, plan.rows.stop], "max_rate": plan.max_rate,
            "shards": len(batch.shards), "sum": float(s[0]), "max": int(mx[0]),
        }
    finally:
        dist.destroy_process_group()


def test_two_process_ingest_and_cross_host_aggregation():
    from data_accelerator_tpu.dist import assigned_partitions as jassigned_partitions

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": root}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), port],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for pid in range(HOSTS)
    ]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
            r = json.loads([ln for ln in out.decode().splitlines() if ln.startswith("{")][-1])
            results[r["pid"]] = r
    finally:
        # a worker that died before the rendezvous leaves the other
        # waiting in it: never orphan it
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)

    n = results[0]["rows_per_host"]
    assert n == results[1]["rows_per_host"] == SHARDS * ROWS_PER_SHARD
    for pid in range(HOSTS):
        r = results[pid]
        assert r["partitions"] == jassigned_partitions(4, pid, HOSTS) == [pid, pid + 2]
        assert r["rows"] == [pid * n, (pid + 1) * n]
        assert r["max_rate"] == 4000.0 and r["shards"] == SHARDS
    # BOTH hosts see the GLOBAL aggregate: host 0's rows are 10.0 each,
    # host 1's 20.0; the max id was ingested by host 1 only, so host 0
    # seeing it proves the cross-host collective
    assert results[0]["sum"] == results[1]["sum"] == n * 10.0 + n * 20.0
    assert results[0]["max"] == results[1]["max"] == 100 + n - 1


if __name__ == "__main__":
    print(json.dumps(worker(int(sys.argv[1]), sys.argv[2])), flush=True)
