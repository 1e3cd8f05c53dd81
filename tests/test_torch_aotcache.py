"""The port's kernel build cache (``compile/aotcache.py`` over
``kernels/build.py``) against the JAX package's persistent compilation
cache (``tests/test_compilecheck.py``).

- Library keys: the same bytes at two paths name one library; one
  changed byte, a changed flag or another compiler version names
  another.
- ``test_persistent_cache_hits_across_restarts`` and
  ``test_compile_cache_routes_through_objstore`` mirrored on the host
  route (``g++``, the port's decoder library), which builds here. Each
  start is a process of its own, since a loaded library is
  process-wide: the cold start compiles and misses, a restart on the
  same directory and a replica on another directory that pulls through
  ``cacheurl`` run no compiler.
- The shared layer fails open: an unreachable store warns and the
  library builds locally. A stray ``.tmp`` entry is never loaded.
- A processor with ``compile.cachedir`` reports ``Compile_Cache_Hit_Count``
  and ``Compile_Cache_Miss_Count`` as the JAX processor does. The
  deliberate difference: the JAX package counts XLA executables, of
  which a CPU warm compiles several, and the port counts kernel
  libraries, of which a CPU step loads none, so the port's counts are
  what the directory held and 0.
"""

import copy
import hashlib
import json
import os
import stat
import subprocess
import sys
import uuid
from pathlib import Path

import pytest

from data_accelerator_tpu.analysis import compilecheck as jcomp
from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.analysis import compilecheck as tcomp
from data_accelerator_tpu_torch.compile.aotcache import PersistentCompileCache
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.kernels import build
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreClient, ObjectStoreServer

from tests.test_torch_compilecheck import _conf_for_gui, _flows

ROOT = Path(__file__).resolve().parent.parent
DECODER = build.CSRC_DIR / "decoder.cpp"


def _fake_compiler(path: Path, version: str) -> str:
    path.write_text(f'#!/bin/sh\necho "{version}"\n')
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


# -- library keys -----------------------------------------------------------------------
def test_same_bytes_at_two_paths_name_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    nvcc = _fake_compiler(tmp_path / "nvcc", "stand-in nvcc 1")
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    a, b = tmp_path / "one" / "k.cu", tmp_path / "two" / "k.cu"
    for p in (a, b):
        p.parent.mkdir()
        p.write_text("// the same kernel\n")
    assert build.library_path(a) == build.library_path(b)
    assert build.library_path(a).parent == tmp_path / "_build"
    # the host route too: two checkouts of the decoder name one library
    c = tmp_path / "checkout" / "decoder.cpp"
    c.parent.mkdir()
    c.write_bytes(DECODER.read_bytes())
    assert (build._library_path(c, build.HOST_FLAGS, "g++").name
            == build._library_path(DECODER, build.HOST_FLAGS, "g++").name)


@pytest.mark.parametrize("change", ["byte", "flag", "compiler"])
def test_a_changed_byte_flag_or_compiler_names_another_library(tmp_path, monkeypatch, change):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    nvcc = _fake_compiler(tmp_path / "nvcc", "stand-in nvcc 1")
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    first = build.library_path(src)
    if change == "byte":
        src.write_text("// a kernel!\n")
    elif change == "flag":
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    else:
        other = _fake_compiler(tmp_path / "nvcc2", "stand-in nvcc 2")
        monkeypatch.setattr(build, "nvcc_path", lambda: other)
    assert build.library_path(src) != first
    assert build.library_path(src).name.startswith("libk-")


def test_no_compiler_still_names_a_library_that_nothing_built(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    nvcc = _fake_compiler(tmp_path / "nvcc", "stand-in nvcc 1")
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    built = build.library_path(src)

    def missing():
        raise build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", missing)
    assert build.library_path(src) != built
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build([src])


# -- restarts and replicas, each a process of its own -----------------------------------
CHILD = """
import ctypes, json, sys
from data_accelerator_tpu_torch.compile.aotcache import PersistentCompileCache
from data_accelerator_tpu_torch.kernels import build
src, cache_dir, url = sys.argv[1], sys.argv[2] or None, sys.argv[3] or None
cache = PersistentCompileCache(cache_dir, url)
cache.enable()
hits = cache.file_count()
lib = build.load_host(src)
lib.dx_crc32c.restype = ctypes.c_uint32
lib.dx_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
crc = lib.dx_crc32c(b"123456789", 9)
misses = cache.push()
print(json.dumps({"compiles": build.compiler_runs(), "hits": hits, "misses": misses,
                  "pulled": cache.pulled, "library": str(build.build_host(src)),
                  "dir": cache.dir, "crc": crc}))
"""


def _start(src: Path, cache_dir=None, url=None, tmpdir=None) -> dict:
    """One process's start: arm the cache, load the decoder library
    (building it on a miss), push what it built."""
    env = dict(os.environ, **({"TMPDIR": str(tmpdir)} if tmpdir else {}))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(src), str(cache_dir or ""), url or ""],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _fresh_decoder(tmp_path: Path) -> Path:
    """The port's decoder with a comment of its own, so that no library
    an earlier process built matches it and the first start compiles."""
    src = tmp_path / "src" / "decoder.cpp"
    src.parent.mkdir()
    src.write_bytes(DECODER.read_bytes() + f"// {uuid.uuid4().hex}\n".encode())
    return src


def test_persistent_cache_hits_across_restarts(tmp_path):
    """A restart against the same cachedir loads instead of compiling:
    the first start's misses are the restart's hits."""
    src = _fresh_decoder(tmp_path)
    cold = _start(src, tmp_path / "cache")
    assert cold["compiles"] == {"g++": 1}
    assert cold["misses"] == 1 and cold["hits"] == 0
    assert Path(cold["library"]).parent == tmp_path / "cache"
    assert (tmp_path / "cache" / Path(cold["library"]).name).exists()
    warm = _start(src, tmp_path / "cache")
    assert warm["compiles"] == {}
    assert warm["hits"] >= cold["misses"]
    assert warm["misses"] == 0
    assert warm["library"] == cold["library"]
    # CRC-32C's check value: the library loaded and runs
    assert cold["crc"] == warm["crc"] == 0xE3069283


def test_compile_cache_routes_through_objstore(tmp_path):
    """cacheurl = objstore:// prefix: the first start pushes what it
    built to the shared store; a replica with a DIFFERENT local dir
    pulls it back and compiles nothing (the preemption-recovery /
    scale-out path)."""
    src = _fresh_decoder(tmp_path)
    store = ObjectStoreServer(port=0, root=str(tmp_path / "store")).start()
    try:
        client = ObjectStoreClient(store.endpoint)
        url = client.url_for("flows/CacheFlow/compilecache")
        first = _start(src, tmp_path / "a", url)
        assert first["compiles"] == {"g++": 1} and first["misses"] == 1
        keys = client.list("flows/CacheFlow/compilecache")
        libraries = [k for k in keys if k.endswith(".so")]
        assert [k.rsplit("/", 1)[-1] for k in libraries] == [Path(first["library"]).name]
        replica = _start(src, tmp_path / "b", url)
        assert replica["compiles"] == {}
        assert replica["pulled"] >= len(libraries)
        assert replica["hits"] >= len(libraries) and replica["misses"] == 0
        pulled = [f for f in os.listdir(tmp_path / "b") if f.endswith(".so")]
        assert len(pulled) >= len(libraries)
        assert not [f for f in os.listdir(tmp_path / "b") if f.endswith(".tmp")]
        # no local dir given: a deterministic one per URL, under the
        # process's temporary directory
        (tmp_path / "tmp").mkdir()
        shared = _start(src, None, url, tmpdir=tmp_path / "tmp")
        assert shared["compiles"] == {} and shared["pulled"] >= len(libraries)
        assert shared["dir"] == os.path.join(
            tmp_path / "tmp", "dxtpu-torch-compile-cache",
            hashlib.sha256(url.encode()).hexdigest()[:16])
    finally:
        store.stop()


def test_unreachable_store_warns_and_builds_locally(tmp_path, caplog):
    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int dx_answer() { return 42; }\n'
                   f"// {uuid.uuid4().hex}\n")
    # nothing listens on port 1 of this host: every request is refused
    cache = PersistentCompileCache(str(tmp_path / "cache"), "objstore://127.0.0.1:1/b/cache")
    before = build.compiler_runs().get("g++", 0)
    cache.enable()
    try:
        assert cache.pulled == 0
        path = build.build_host(src)
        assert path.parent == tmp_path / "cache"
        assert cache.push() == 1
    finally:
        cache.disable()
    assert build.compiler_runs().get("g++", 0) == before + 1
    assert "compile-cache pull failed" in caplog.text
    assert "compile-cache push" in caplog.text
    assert build.build_dir() == build.BUILD_DIR


def test_a_stray_tmp_entry_is_never_loaded(tmp_path):
    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int dx_answer() { return 42; }\n'
                   f"// {uuid.uuid4().hex}\n")
    cache = PersistentCompileCache(str(tmp_path / "cache"))
    cache.enable()
    try:
        name = build._library_path(src, build.HOST_FLAGS, build.shutil.which("g++")).name
        # a half-written library under every temporary name a write uses
        for stray in (f"{name}.123.tmp", name[:-3] + ".123.tmp"):
            (tmp_path / "cache" / stray).write_bytes(b"\x7fELF half written")
        assert cache.file_count() == 0
        before = build.compiler_runs().get("g++", 0)
        path = build.build_host(src)
        assert path.name == name and build.compiler_runs()["g++"] == before + 1
        assert build.load_host(src).dx_answer() == 42
        assert cache.file_count() == 1
    finally:
        cache.disable()


def test_build_dir_scope_is_this_threads_and_enable_restores(tmp_path):
    import threading

    seen = {}
    with build.build_dir_scope(tmp_path / "scoped"):
        seen["here"] = build.build_dir()
        t = threading.Thread(target=lambda: seen.setdefault("other", build.build_dir()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen == {"here": tmp_path / "scoped", "other": build.BUILD_DIR}
    assert build.build_dir() == build.BUILD_DIR
    outer = PersistentCompileCache(str(tmp_path / "outer"))
    inner = PersistentCompileCache(str(tmp_path / "inner"))
    outer.enable()
    inner.enable()
    assert build.build_dir() == tmp_path / "inner"
    inner.disable()
    assert build.build_dir() == tmp_path / "outer"
    outer.disable()
    assert build.build_dir() == build.BUILD_DIR


# -- the processor ----------------------------------------------------------------------
def test_processor_reports_both_cache_counts_as_the_jax_processor(tmp_path):
    """Both processors arm the cache at init and report both counts at
    the first batch. The JAX warm compiles XLA executables into its
    directory (misses); the port's CPU step loads no kernel library, so
    it misses 0 and hits what the directory held, on a restart too."""
    jflow, tflow, _ = _flows("dx602_manifest_donation")
    tflow = copy.deepcopy(tflow)
    tflow["process"].setdefault("jobconfig", {})["jobBatchCapacity"] = "64"
    jflow = copy.deepcopy(jflow)
    jflow["process"].setdefault("jobconfig", {})["jobBatchCapacity"] = "64"

    def conf(flow, manifest, cache_dir):
        return _conf_for_gui(flow, {
            "datax.job.process.batchcapacity": "64",
            "datax.job.process.compile.manifest": json.dumps(manifest),
            "datax.job.process.compile.cachedir": str(cache_dir),
        })

    jconf = conf(jflow, jcomp.analyze_flow_compile(jflow, digests=False).manifest,
                 tmp_path / "jax")
    tconf = conf(tflow, tcomp.analyze_flow_compile(tflow, digests=False).manifest,
                 tmp_path / "torch")
    jproc = JFlowProcessor(JSettingDictionary(jconf))
    try:
        jm = {f"Compile_{k}": v for k, v in jproc.compile_stats.items()}
    finally:
        jproc._compile_cache.disable()
    assert jm["Compile_Cache_Miss_Count"] > 0
    for start in ("cold", "restart"):
        tproc = FlowProcessor(SettingDictionary(tconf), device="cpu")
        assert tproc._aot_warmed and tproc._compile_cache.dir == str(tmp_path / "torch")
        tm = {f"Compile_{k}": v for k, v in tproc.compile_stats.items()}
        assert {k for k in tm if k.startswith("Compile_Cache_")} == \
            {k for k in jm if k.startswith("Compile_Cache_")}, start
        assert (tm["Compile_Cache_Hit_Count"], tm["Compile_Cache_Miss_Count"]) == (0, 0)
    assert (tmp_path / "torch").is_dir()
    assert build.build_dir() == build.BUILD_DIR


def test_an_unusable_cachedir_logs_and_builds_locally(tmp_path, caplog):
    _j, tflow, _ = _flows("dx602_manifest_donation")
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    conf = _conf_for_gui(tflow, {
        "datax.job.process.batchcapacity": "64",
        "datax.job.process.compile.manifest": json.dumps(
            tcomp.analyze_flow_compile(tflow, digests=False).manifest),
        "datax.job.process.compile.cachedir": str(blocker / "cache"),
    })
    proc = FlowProcessor(SettingDictionary(conf), device="cpu")
    assert proc._compile_cache is None and proc._aot_warmed
    assert "persistent compile cache unavailable" in caplog.text
    assert not any(k.startswith("Cache_") for k in proc.compile_stats)
