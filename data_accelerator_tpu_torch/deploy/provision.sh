#!/usr/bin/env bash
# Cluster provisioning for the PyTorch/CUDA port (data_accelerator_tpu_torch):
# stand the whole framework up on a Kubernetes cluster with one command —
# the role the reference's DeploymentCloud ARM templates + deploy.ps1 play
# (provision resources, seed secrets, deploy the services), re-targeted
# at k8s with NVIDIA GPU node pools.
#
# What it does, in order:
#   1. namespace + storage (PVC) for shared design/runtime configs; the
#      same volume carries each flow's kernel build cache
#      (runtime/<flow>/compilecache, the generated compile.cachedir), so a
#      restarted job pod loads its kernels instead of compiling them
#   2. secret seeding: every DATAX_SECRET_* env var becomes a key of
#      the `dxtpu-secrets` k8s Secret, surfaced to pods as env vars
#      (the KeyVault-seeding role of deploy.ps1; `keyvault://` conf
#      URIs resolve against these)
#   3. the service manifests: control plane (+ scheduler), gateway +
#      website, metrics ingestor — with the image and GPU job settings
#      substituted. These pods hold no card (device=cpu in their args);
#      the per-flow Jobs the control plane submits get the cards
#   4. waits for the control plane to come up and prints the entry URLs
#
# Requirements: kubectl context pointing at the target cluster; the
# port's image (deploy/Dockerfile of this package) pushed to a registry
# the cluster can pull from; GPU nodes with the NVIDIA device plugin.
#
# Usage:
#   IMAGE=reg.example/dxtpu-torch:v1 ./provision.sh [namespace]
#   DATAX_SECRET_STORE_SASKEY=... IMAGE=... ./provision.sh prod
#
# Environment:
#   IMAGE            engine image ref (default dxtpu-torch:latest)
#   STORAGE_SIZE     PVC size (default 50Gi)
#   STORAGE_CLASS    storage class (default: cluster default)
#   GPU_ACCELERATOR  the GPU pool's cloud.google.com/gke-accelerator
#                    node label for flow jobs (default nvidia-h100-80gb)
#   GPU_TOPOLOGY     the nvidia.com/gpu.count node label: the cards one
#                    node holds (default 8)
#   DRY_RUN=1        print rendered manifests instead of applying

set -euo pipefail

NS="${1:-dxtpu}"
IMAGE="${IMAGE:-dxtpu-torch:latest}"
STORAGE_SIZE="${STORAGE_SIZE:-50Gi}"
STORAGE_CLASS="${STORAGE_CLASS:-}"
GPU_ACCELERATOR="${GPU_ACCELERATOR:-nvidia-h100-80gb}"
GPU_TOPOLOGY="${GPU_TOPOLOGY:-8}"
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

apply() {
  if [[ "${DRY_RUN:-}" == "1" ]]; then
    # document separator: each apply is its own kubectl stream in the
    # real path; the concatenated dry-run output needs explicit breaks
    echo "---"
    cat
  else
    kubectl apply -n "$NS" -f -
  fi
}

render() {
  # substitute the deploy-time variables in a manifest stream. The
  # control plane's serve args additionally gain the k8s job client
  # settings so per-flow GPU Jobs it later submits carry the SAME
  # image/accelerator/topology (K8sJobClient render overrides).
  sed -e "s|image: dxtpu-torch:latest|image: ${IMAGE}|g" \
      -e "s|\"scheduler=60\"|\"scheduler=60\", \"jobclient=k8s\", \"k8s.namespace=${NS}\", \"k8s.image=${IMAGE}\", \"k8s.accelerator=${GPU_ACCELERATOR}\", \"k8s.topology=${GPU_TOPOLOGY}\"|" \
      "$1"
}

echo ">> namespace ${NS}"
if [[ "${DRY_RUN:-}" != "1" ]]; then
  kubectl get ns "$NS" >/dev/null 2>&1 || kubectl create ns "$NS"
fi

echo ">> storage (${STORAGE_SIZE})"
{
  cat <<YAML
apiVersion: v1
kind: PersistentVolumeClaim
metadata:
  name: dxtpu-storage
  labels: {app: dxtpu}
spec:
  accessModes: [ReadWriteMany]
  resources: {requests: {storage: ${STORAGE_SIZE}}}
YAML
  if [[ -n "$STORAGE_CLASS" ]]; then
    echo "  storageClassName: ${STORAGE_CLASS}"
  fi
} | apply

echo ">> secrets"
# every DATAX_SECRET_<VAULT>_<NAME> env var seeds one secret key —
# the deploy.ps1 KeyVault-population step; core/secrets.py resolves
# keyvault://vault/name conf values against these at runtime
# iterate exported VARIABLE NAMES (compgen -e), never raw `env` lines:
# multi-line secret values (PEM keys) would otherwise split apart
SECRET_ARGS=()
while read -r k; do
  [[ "$k" == DATAX_SECRET_* ]] || continue
  SECRET_ARGS+=("--from-literal=${k}=${!k}")
done < <(compgen -e)
if [[ ${#SECRET_ARGS[@]} -gt 0 ]]; then
  if [[ "${DRY_RUN:-}" == "1" ]]; then
    echo "# would seed secret dxtpu-secrets with ${#SECRET_ARGS[@]} key(s)"
  else
    kubectl -n "$NS" create secret generic dxtpu-secrets \
      "${SECRET_ARGS[@]}" --dry-run=client -o yaml | kubectl apply -n "$NS" -f -
  fi
else
  echo "   (no DATAX_SECRET_* vars set; skipping)"
fi

echo ">> services"
for m in control-plane gateway-web metrics-ingestor; do
  render "${HERE}/k8s/${m}.yaml" | apply
done
# serve/k8s/gpu-job.yaml is NOT applied here: it is the per-flow template
# the control plane's K8sJobClient renders and submits at job start

if [[ "${DRY_RUN:-}" == "1" ]]; then
  echo "# dry run complete"
  exit 0
fi

echo ">> waiting for control plane"
kubectl -n "$NS" rollout status deploy/dxtpu-control-plane --timeout=300s

GATEWAY=$(kubectl -n "$NS" get svc dxtpu-web \
  -o jsonpath='{.status.loadBalancer.ingress[0].ip}' 2>/dev/null || true)
echo ""
echo "dxtpu-torch is up in namespace ${NS}."
echo "  gateway/web: http://${GATEWAY:-<pending-lb-ip>}/"
echo "  control plane (in-cluster): http://dxtpu-control-plane.${NS}:5000"
echo "  submit GPU jobs via the control plane (jobclient=k8s) or the UI."
