"""The port's deployment stack (``data_accelerator_tpu_torch/deploy/``)
against the JAX package's (``tests/test_onebox_e2e.py``
``test_provision_script_renders_valid_stack``): ``provision.sh`` in
``DRY_RUN`` renders the port's stack with the image and the GPU job
placement substituted, the control-plane pods ask for the CPU in their
args, and no file of the stack names the JAX package, JAX or a TPU
resource. The image itself is not built here."""

import os
import re
import subprocess

import pytest
import yaml

from data_accelerator_tpu_torch.serve.jobs import make_job_client

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(ROOT, "data_accelerator_tpu_torch", "deploy")
SCRIPTS = ("provision.sh", "onebox.sh")
# the JAX package as a module, JAX itself, or a TPU resource
FORBIDDEN = re.compile(r"data_accelerator_tpu(?!_torch)|jax|google\.com/tpu|tpu-v\d",
                       re.IGNORECASE)


def _read(name):
    with open(os.path.join(DEPLOY, name), encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module")
def rendered():
    out = subprocess.run(
        ["bash", os.path.join(DEPLOY, "provision.sh"), "testns"],
        env={**os.environ, "DRY_RUN": "1", "IMAGE": "reg.example/dxtpu-torch:v7",
             "GPU_ACCELERATOR": "nvidia-h100-mega-80gb", "GPU_TOPOLOGY": "4",
             "STORAGE_CLASS": "fast",
             # multi-line value: seeding must keep it ONE secret
             "DATAX_SECRET_MAINVAULT_TLSKEY":
                 "-----BEGIN KEY-----\nabc=def\n-----END KEY-----"},
        capture_output=True, text=True, check=True, timeout=60,
    )
    # strip the >> progress lines; the rest must be YAML documents
    text = "\n".join(ln for ln in out.stdout.splitlines() if not ln.startswith(">>"))
    return out.stdout, text, [d for d in yaml.safe_load_all(text) if d]


def test_provision_script_renders_valid_stack(rendered):
    stdout, text, docs = rendered
    kinds = sorted(d["kind"] for d in docs)
    assert kinds.count("Deployment") >= 3  # control plane, gateway/web, ingestor
    assert "PersistentVolumeClaim" in kinds
    assert "Service" in kinds
    assert "Job" not in kinds  # per-flow Jobs are the control plane's to submit
    assert "reg.example/dxtpu-torch:v7" in text
    assert "dxtpu-torch:latest" not in text  # image substituted everywhere
    assert "storageClassName: fast" in text
    assert "would seed secret dxtpu-secrets with 1 key(s)" in stdout
    # the control plane submits per-flow GPU jobs itself; provisioning
    # must hand it the SAME image + GPU placement
    assert "jobclient=k8s" in text
    assert "k8s.image=reg.example/dxtpu-torch:v7" in text
    assert "k8s.accelerator=nvidia-h100-mega-80gb" in text
    assert "k8s.topology=4" in text
    assert "k8s.namespace=testns" in text


def _containers(docs):
    for d in docs:
        if d["kind"] == "Deployment":
            for c in d["spec"]["template"]["spec"]["containers"]:
                yield d["metadata"]["name"], c


def test_every_service_runs_the_port_and_asks_for_the_cpu(rendered):
    """The service pods hold no card: each says device=cpu in its args
    (the caller asking for the CPU, not a fallback) and requests no
    nvidia.com/gpu; every one runs the port's serve module."""
    _stdout, _text, docs = rendered
    names = set()
    for name, c in _containers(docs):
        names.add(name)
        assert c["command"] == ["python", "-m", "data_accelerator_tpu_torch.serve"], name
        assert "device=cpu" in c["args"], name
        assert "nvidia.com/gpu" not in str(c.get("resources", {})), name
    assert names == {"dxtpu-control-plane", "dxtpu-gateway-web", "dxtpu-metrics-ingestor"}


def test_the_control_planes_args_build_the_gpu_job_client(rendered):
    """The rendered k8s.* args, as the port's serve module reads them,
    give a K8sJobClient whose Jobs run on the named GPU pool."""
    _stdout, _text, docs = rendered
    [args] = [c["args"] for n, c in _containers(docs) if n == "dxtpu-control-plane"]
    kv = dict(a.split("=", 1) for a in args)
    client = make_job_client(
        {"type": kv["jobclient"], **{k[4:]: v for k, v in kv.items() if k.startswith("k8s.")}})
    m = client.render_manifest({"name": "f1", "confPath": "c.conf"})
    pod = m["spec"]["template"]["spec"]
    assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-mega-80gb"
    assert pod["nodeSelector"]["nvidia.com/gpu.count"] == "4"
    assert pod["containers"][0]["image"] == "reg.example/dxtpu-torch:v7"
    assert pod["containers"][0]["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert client.namespace == "testns"


@pytest.mark.parametrize("name", ["rendered", "Dockerfile", "onebox.sh", "provision.sh",
                                  "k8s/control-plane.yaml", "k8s/gateway-web.yaml",
                                  "k8s/metrics-ingestor.yaml"])
def test_no_deploy_file_names_jax_or_a_tpu(name, rendered):
    text = rendered[0] if name == "rendered" else _read(name)
    assert not FORBIDDEN.findall(text), name


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_parse(script):
    proc = subprocess.run(["bash", "-n", os.path.join(DEPLOY, script)],
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr


def test_onebox_runs_the_port_server_on_the_card():
    text = _read("onebox.sh")
    assert "exec python -m data_accelerator_tpu_torch.serve" in text
    # no device= argument: the server takes the card, and exits 2
    # naming it when there is none
    assert "device=" not in text
    for arg in ("port=", "web=", "ingest=", "scheduler=", "roles=", "root="):
        assert arg in text


def test_dockerfile_copies_the_port_prebuilds_csrc_and_enters_onebox():
    text = _read("Dockerfile")
    instructions = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    [base] = [ln for ln in instructions if ln.startswith("FROM ")]
    assert "devel" in base and "cuda" in base  # nvcc in the image
    copies = [ln for ln in instructions if ln.startswith("COPY ")]
    assert copies == ["COPY data_accelerator_tpu_torch/ data_accelerator_tpu_torch/"]
    assert "torch" in text and "numpy" in text and "pyyaml" in text
    # every csrc source built with the port's build module, at image build
    assert "from data_accelerator_tpu_torch.kernels import build" in text
    assert "CSRC_DIR.glob('*.cu')" in text and "CSRC_DIR.glob('*.cpp')" in text
    assert instructions[-1] == \
        'ENTRYPOINT ["bash", "data_accelerator_tpu_torch/deploy/onebox.sh"]'
