"""``theanompi_tpu_torch/utils/compile_cache.py``: the kernel libraries'
cache, on the CPU, with a stand-in compiler.

This box has no ``nvcc``: a script named ``nvcc`` under
``tmp_path/bin``, reached through ``CUDA_HOME``, answers ``--version``
with the version written into it and builds a shared object from a
one-line C file with the host's ``cc`` (it fails when told to).  Every
test writes only under ``tmp_path``; the default directory
(``_kernel_build.BUILD_DIR``) is pointed there too.  The counterpart of
``tests/test_compile_cache.py``: a fresh process hits where the first
missed, the key follows the source, the flags and the toolkit, a corrupt
or version-drifted library is rebuilt and counted, an unusable directory
disables the cache, a failed build raises, ``resolve``'s rules, the
manifest, the launcher's ``--compile-cache`` and the worker's start-up
lines.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from theanompi_tpu_torch import launcher as TL
from theanompi_tpu_torch.ops import _kernel_build as kb
from theanompi_tpu_torch.utils import compile_cache as cc

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

pytestmark = pytest.mark.skipif(shutil.which("cc") is None,
                                reason="the stand-in compiler needs cc")

NVCC = r"""#!/bin/sh
# stand-in nvcc: --version, or -o OUT built from one.c by cc
here="$(dirname "$0")"
if [ "$1" = "--version" ]; then
  printf 'nvcc: stand-in\nCuda compilation tools, release %s\nBuild %s\n' \
      "VERSION" "VERSION"
  exit 0
fi
if [ -f "$here/fail" ]; then echo "stand-in nvcc: failing as told" >&2; exit 2; fi
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo built >> "$here/calls"
exec cc -shared -fPIC -o "$out" "$here/one.c"
"""


def _standin(tmp_path, version="12.9"):
    """The stand-in toolkit under ``tmp_path`` (its ``bin/nvcc``)."""
    b = tmp_path / "cuda" / "bin"
    b.mkdir(parents=True, exist_ok=True)
    (b / "one.c").write_text("int theanompi_standin(void) { return 7; }\n")
    nvcc = b / "nvcc"
    nvcc.write_text(NVCC.replace("VERSION", version))
    nvcc.chmod(0o755)
    return str(tmp_path / "cuda")


def _calls(cuda):
    p = os.path.join(cuda, "bin", "calls")
    return len(open(p).read().split()) if os.path.exists(p) else 0


CHILD = r"""
import json, sys
from theanompi_tpu_torch.ops import _kernel_build as kb
from theanompi_tpu_torch.utils import compile_cache as cc
kb.BUILD_DIR = sys.argv[2]
cache = cc.resolve({"compile_cache": sys.argv[1]} if sys.argv[1] != "-"
                   else {})
kb.use_cache(cache)
libs = {n: kb.load(n).theanompi_standin() for n in sys.argv[3:]}
print(json.dumps({"loads": kb.loads(), "ret": libs,
                  "counters": cache.counters, "enabled": cache.enabled}))
"""


def _child(cuda, cache_dir, build_dir, *names, env=None):
    """A fresh process loading ``names`` through the cache (``-``: none);
    its loads, return values and counters."""
    r = subprocess.run(
        [sys.executable, "-c", CHILD, str(cache_dir), str(build_dir),
         *names], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_HOME=cuda, PYTHONPATH=REPO, **(env or {})))
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_fresh_process_hits_where_the_first_missed(tmp_path):
    cuda = _standin(tmp_path)
    cache, dflt = tmp_path / "cache", tmp_path / "default"
    cold = _child(cuda, cache, dflt, "lrn", "compress")
    assert {n: i["cache"] for n, i in cold["loads"].items()} == \
        {"lrn": "miss", "compress": "miss"}
    assert cold["loads"]["lrn"]["build_secs"] is not None
    assert cold["ret"] == {"lrn": 7, "compress": 7}
    assert cold["counters"]["misses"] == 2
    warm = _child(cuda, cache, dflt, "lrn", "compress")
    assert {n: i["cache"] for n, i in warm["loads"].items()} == \
        {"lrn": "hit", "compress": "hit"}
    assert warm["counters"] == {"hits": 2, "misses": 0,
                                "deserialize_fallbacks": 0,
                                "serialize_unsupported": 0}
    assert _calls(cuda) == 2                   # the warm process built none
    assert not dflt.exists()                   # the default dir untouched
    lib = cold["loads"]["lrn"]["path"]
    assert os.path.dirname(lib) == str(cache) and lib.endswith(".so")


def test_key_follows_source_flags_and_toolkit(tmp_path, monkeypatch):
    src = b"__global__ void k() {}\n"
    flags = list(kb.NVCC_FLAGS)
    base = cc.library_key(src, flags, "release 12.9")
    assert base == cc.library_key(src, flags, "release 12.9")
    others = {cc.library_key(src + b"//\n", flags, "release 12.9"),
              cc.library_key(src, flags + ["-G"], "release 12.9"),
              cc.library_key(src, flags, "release 12.8")}
    assert len(others) == 3 and base not in others
    # the library's key (and its default path) reads the toolkit
    monkeypatch.setenv("CUDA_HOME", _standin(tmp_path / "a", "12.9"))
    k1, p1 = kb.library_key("lrn"), kb.library_path("lrn")
    assert kb.toolkit_version() == "Cuda compilation tools, release 12.9 " \
                                   "Build 12.9"
    monkeypatch.setenv("CUDA_HOME", _standin(tmp_path / "b", "12.8"))
    k2, p2 = kb.library_key("lrn"), kb.library_path("lrn")
    assert k1 != k2 and p1 != p2
    monkeypatch.setattr(kb, "NVCC_FLAGS", kb.NVCC_FLAGS + ("-lineinfo",))
    assert kb.library_key("lrn") not in (k1, k2)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "lrn.cu").write_bytes(
        open(os.path.join(kb.CSRC, "lrn.cu"), "rb").read() + b"\n")
    k3 = kb.library_key("lrn")
    monkeypatch.setattr(kb, "CSRC", str(csrc))
    assert kb.library_key("lrn") != k3


def test_corrupt_library_is_rebuilt_and_counted(tmp_path):
    cuda = _standin(tmp_path)
    cache, dflt = tmp_path / "cache", tmp_path / "default"
    path = _child(cuda, cache, dflt, "lrn")["loads"]["lrn"]["path"]
    with open(path, "wb") as f:
        f.write(b"\x00not a shared object\x01" * 64)
    again = _child(cuda, cache, dflt, "lrn")
    info = again["loads"]["lrn"]
    assert info["cache"] == "deserialize_fallback", info
    assert again["counters"]["deserialize_fallbacks"] == 1
    assert again["ret"]["lrn"] == 7 and _calls(cuda) == 2
    assert _child(cuda, cache, dflt, "lrn")["loads"]["lrn"]["cache"] == "hit"


def test_library_of_another_toolkit_is_rebuilt(tmp_path):
    cuda = _standin(tmp_path)
    cache, dflt = tmp_path / "cache", tmp_path / "default"
    path = _child(cuda, cache, dflt, "lrn")["loads"]["lrn"]["path"]
    head = path[:-3] + ".json"
    header = json.load(open(head))
    assert header["nvcc"].startswith("Cuda compilation tools, release 12.9")
    header["nvcc"] = "release 11.0, somebody else's toolkit"
    json.dump(header, open(head, "w"))
    again = _child(cuda, cache, dflt, "lrn")
    info = again["loads"]["lrn"]
    assert info["cache"] == "deserialize_fallback"
    assert "somebody else's toolkit" in info["fallback_reason"]
    assert again["counters"]["deserialize_fallbacks"] == 1
    assert json.load(open(head))["nvcc"] == header["nvcc"].replace(
        "release 11.0, somebody else's toolkit",
        "Cuda compilation tools, release 12.9 Build 12.9")
    # a missing header is a fallback too
    os.remove(head)
    assert _child(cuda, cache, dflt, "lrn")["loads"]["lrn"]["cache"] == \
        "deserialize_fallback"


def test_unusable_directory_disables_the_cache(tmp_path):
    cuda = _standin(tmp_path)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    c = cc.CompileCache(str(blocker / "cache"))
    assert not c.enabled
    dflt = tmp_path / "default"
    out = _child(cuda, blocker / "cache", dflt, "lrn")
    assert not out["enabled"]
    info = out["loads"]["lrn"]
    assert info["cache"] == "off"
    assert os.path.dirname(info["path"]) == str(dflt)
    assert os.path.exists(info["path"]) and out["ret"]["lrn"] == 7


def test_no_cache_builds_into_the_default_directory(tmp_path):
    cuda = _standin(tmp_path)
    dflt = tmp_path / "default"
    out = _child(cuda, "-", dflt, "lrn", env={cc.ENV_CACHE_DIR: ""})
    info = out["loads"]["lrn"]
    assert info["cache"] == "off" and info["build_secs"] is not None
    assert os.path.basename(info["path"]).startswith("lrn-")
    assert os.path.dirname(info["path"]) == str(dflt)
    # as before the cache: an existing library is reused, not rebuilt
    again = _child(cuda, "-", dflt, "lrn", env={cc.ENV_CACHE_DIR: ""})
    assert again["loads"]["lrn"]["build_secs"] is None and _calls(cuda) == 1


def test_model_compile_info_says_off_on_the_cpu(tmp_path):
    import torch_port_helper as helper
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess({"device": "cpu", "verbose": False})
    proc.get_internode_comm()
    try:
        m = helper.TinyLRNNet({"device": "cpu", "verbose": False,
                               "compile_cache": str(tmp_path / "c")})
        m.compile_iter_fns()
        assert m.compile_cache.enabled
        info = m.compile_info
        assert info["kernels"] == {"cache": "off", "libraries": {},
                                   "compile_secs": None}
        assert info["train"]["cache"] == "off"
        assert info["train"]["storable"] is False
    finally:
        proc.close()


def test_resolve_rules(tmp_path, monkeypatch):
    d = str(tmp_path / "a")
    monkeypatch.delenv(cc.ENV_CACHE_DIR, raising=False)
    assert not cc.resolve({}).enabled
    assert cc.resolve({"compile_cache": d}).enabled
    assert cc.resolve({"compile_cache": d}) is cc.get(d)
    assert cc.resolve({"compile_cache": d}).cache_dir == os.path.abspath(d)
    for off in (False, ""):
        assert not cc.resolve({"compile_cache": off}).enabled
    env = str(tmp_path / "env")
    monkeypatch.setenv(cc.ENV_CACHE_DIR, env)
    assert cc.resolve({}).cache_dir == os.path.abspath(env)
    assert cc.resolve({"compile_cache": d}).cache_dir == os.path.abspath(d)
    assert not cc.resolve({"compile_cache": False}).enabled
    assert not cc.resolve({"aot_cache": False}).enabled
    assert not cc.resolve({"aot_cache": False, "compile_cache": d}).enabled
    assert "0 hit / 0 miss" in cc.get(d).describe()


def test_manifest_holds_its_fields(tmp_path):
    cuda = _standin(tmp_path)
    cache, dflt = tmp_path / "cache", tmp_path / "default"
    _child(cuda, cache, dflt, "lrn")
    m = json.load(open(cache / "manifest.json"))
    (key, e), = m.items()
    assert e["name"] == "lrn" and e["hits"] == 0 and e["last_hit"] is None
    assert e["nvcc"] == "Cuda compilation tools, release 12.9 Build 12.9"
    assert e["bytes"] == os.path.getsize(cache / f"lrn-{key}.so") > 0
    assert e["build_secs"] >= 0
    _child(cuda, cache, dflt, "lrn")
    e = json.load(open(cache / "manifest.json"))[key]
    assert e["hits"] == 1 and e["last_hit"] >= e["created"]


def test_failed_build_still_raises(tmp_path, monkeypatch):
    cuda = _standin(tmp_path)
    (tmp_path / "cuda" / "bin" / "fail").write_text("")
    monkeypatch.setenv("CUDA_HOME", cuda)
    monkeypatch.setattr(kb, "BUILD_DIR", str(tmp_path / "default"))
    for cache in (cc.CompileCache(str(tmp_path / "cache")),
                  cc.get(None)):
        with pytest.raises(RuntimeError, match="failing as told"):
            kb._load("lrn", cache)
    assert not [f for f in os.listdir(tmp_path / "cache")
                if f.endswith(".so")]


def test_prewarm_command_builds_every_library(tmp_path):
    cuda = _standin(tmp_path)
    cache = tmp_path / "cache"
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.utils.compile_cache",
         str(cache)], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_HOME=cuda, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    for name in kb.sources():
        assert f"{name}: miss" in r.stdout
    assert f"{len(kb.sources())} miss" in r.stdout
    out = _child(cuda, cache, tmp_path / "default", *kb.sources())
    assert set(i["cache"] for i in out["loads"].values()) == {"hit"}


def test_launcher_passes_compile_cache_to_each_rank(capsys):
    rc = TL.main(["--emit-only", "--n-workers", "2", "--compile-cache",
                  "/tmp/cc", "device=cpu"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "rank" in ln and "theanompi_tpu_torch.worker" in ln]
    assert len(lines) == 2
    assert all("compile_cache=/tmp/cc" in ln for ln in lines)
    # a rank config that sets the key keeps its own
    TL.main(["--emit-only", "--n-workers", "1", "--compile-cache", "/tmp/cc",
             "device=cpu", "compile_cache=/tmp/mine"])
    out = capsys.readouterr().out
    assert "compile_cache=/tmp/mine" in out and "compile_cache=/tmp/cc" \
        not in out


def test_worker_prints_its_start_up_lines(tmp_path, capsys):
    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=1, modelfile="torch_port_helper",
              modelclass="TinyLRNNet", device="cpu", printFreq=100,
              compile_cache=str(tmp_path / "c"))
    rule.wait()
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("start-up")]
    assert line == [
        "start-up (s from process start): " + ", ".join(
            f"{k} " + ("-" if v is None else f"{v:.2f}")
            for k, v in rule.worker.startup.items())]
    assert list(rule.worker.startup) == ["torch", "cuda", "model",
                                         "kernels", "capture", "step"]
    assert rule.worker.startup["cuda"] is None      # the CPU has no context
    assert 0 < rule.worker.startup["model"] <= rule.worker.startup["step"]
    assert ("compile cache [0 hit / 0 miss / 0 load-fallback / 0 "
            "unserializable (dir=") in out
    assert "kernels: off | train: off" in out
