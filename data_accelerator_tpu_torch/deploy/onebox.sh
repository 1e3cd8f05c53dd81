#!/usr/bin/env bash
# One-box entry of the port's image: the full stack in one process tree
# on the container's cards (docker run --gpus all).
# reference: DeploymentLocal/finalrun.sh — starts Spark local, the Flow
# management service, and the website, then tails forever. Here the
# port's serve module composes control plane + website + scheduler +
# metrics ingestor in one process; flow jobs fork off it via the
# LocalJobClient, each a data_accelerator_tpu_torch.runtime.host on the
# card. Without a card the server exits 2, naming it.
#
# Ports: 5000 control-plane REST, 5001 website, 5002 metrics ingestor.
set -euo pipefail

ROOT="${DATAX_ROOT:-/var/dxtpu}"
mkdir -p "$ROOT"

exec python -m data_accelerator_tpu_torch.serve \
  port="${DATAX_API_PORT:-5000}" \
  web="${DATAX_WEB_PORT:-5001}" \
  ingest="${DATAX_INGEST_PORT:-5002}" \
  scheduler="${DATAX_SCHEDULER_INTERVAL:-60}" \
  roles="${DATAX_REQUIRE_ROLES:-false}" \
  root="$ROOT"
