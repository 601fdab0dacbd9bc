"""The port's lint tools: the pre-commit entry
(``python -m theanompi_tpu_torch.tools.precommit_lint``) and the
compile cache's explainer (``python -m
theanompi_tpu_torch.tools.explain_program``), counterparts of
``scripts/precommit_lint.sh`` and ``scripts/explain_program.py``.

The hook runs in a ``git init`` under ``tmp_path``: it lints the staged
blobs, not the worktree, exits 1 on a staged finding and 0 on a clean
stage, and ``TPULINT_SARIF`` writes a SARIF 2.1.0 log.  The explainer
reads a manifest the port's ``CompileCache`` wrote: its table, ``--json``
and a ``--diff`` that names the key part that split two entries (and says
``unknown`` for an entry of the manifest before it kept the parts).
"""

import json
import os
import subprocess
import sys

import pytest

from theanompi_tpu_torch.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _git(cwd, *args):
    return subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=str(cwd), capture_output=True, text=True, timeout=60)


PRECOMMIT = "theanompi_tpu_torch.tools.precommit_lint"


def test_precommit_lints_the_staged_blobs(tmp_path):
    assert _git(tmp_path, "init", "-q").returncode == 0
    pkg = tmp_path / "theanompi_tpu_torch"
    pkg.mkdir()
    r = _run(PRECOMMIT, cwd=tmp_path)
    assert r.returncode == 0 and "no staged python files" in r.stdout

    (pkg / "ok.py").write_text("x = 1\n")
    _git(tmp_path, "add", "-A")
    r = _run(PRECOMMIT, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr

    # a staged finding fails the hook, even with the worktree fixed
    (pkg / "bad.py").write_text("def f():\n    import jax\n    return jax\n")
    _git(tmp_path, "add", "-A")
    (pkg / "bad.py").write_text("x = 2\n")
    sarif = tmp_path / "out.sarif"
    r = _run(PRECOMMIT, cwd=tmp_path,
             env_extra={"TPULINT_SARIF": str(sarif)})
    assert r.returncode == 1, r.stdout + r.stderr
    assert "package-boundary" in r.stdout and "bad.py:2:" in r.stdout
    log = json.loads(sarif.read_text())
    assert log["version"] == "2.1.0" and "sarif-2.1.0" in log["$schema"]
    (res,) = log["runs"][0]["results"]
    assert res["ruleId"] == "package-boundary"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "theanompi_tpu_torch/bad.py"
    assert loc["region"]["startLine"] == 2

    # staging the fix clears it
    _git(tmp_path, "add", "-A")
    r = _run(PRECOMMIT, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr


def test_precommit_outside_a_checkout_is_a_usage_error(tmp_path):
    r = _run(PRECOMMIT, cwd=tmp_path,
             env_extra={"GIT_CEILING_DIRECTORIES": str(tmp_path.parent)})
    assert r.returncode == 2


EXPLAIN = "theanompi_tpu_torch.tools.explain_program"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3"]


@pytest.fixture
def manifest_dir(tmp_path):
    """A cache directory whose manifest the port's CompileCache wrote:
    ``lrn`` under two flag sets, and an entry of the older manifest."""
    cache = cc.CompileCache(str(tmp_path / "cache"))
    src = b"__global__ void lrn_fwd_kernel() {}\n"
    for flags, secs in ((FLAGS, 20.5), (FLAGS + ["-lineinfo"], 21.0)):
        parts = cc.key_parts(src, flags, "release 12.4, V12.4.131")
        cache._record_manifest(cc.library_key(src, flags,
                                              "release 12.4, V12.4.131"),
                               "lrn", "release 12.4, V12.4.131", secs, 4096,
                               parts)
    cache._record_manifest("0ld0" * 10, "compress", "release 12.4", 30.0,
                           8192)
    return cache.cache_dir, cache.load_manifest()


def test_explain_table_and_json(manifest_dir):
    d, manifest = manifest_dir
    r = _run(EXPLAIN, d, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("lrn") == 2 and "compress" in r.stdout
    assert "unknown" in r.stdout and "predates the key parts" in r.stderr
    r = _run(EXPLAIN, d, "--json", cwd=REPO)
    assert r.returncode == 0 and json.loads(r.stdout) == manifest
    entry = next(e for e in manifest.values() if e.get("flags") == FLAGS)
    assert len(entry["source"]) == 64 and entry["nvcc"].startswith("release")


def test_explain_diff_names_the_part_that_split_two_keys(manifest_dir):
    d, manifest = manifest_dir
    a, b = sorted((k for k, e in manifest.items() if e["name"] == "lrn"),
                  key=lambda k: len(manifest[k]["flags"]))
    r = _run(EXPLAIN, d, "--diff", a[:8], b[:8], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "key split: flags" in r.stdout and "'-lineinfo'" in r.stdout
    assert "source" not in r.stdout.split("key split:")[1].split("\n")[0]
    r = _run(EXPLAIN, d, "--diff", a[:8], "compress", cwd=REPO)
    assert r.returncode == 0 and "key split: unknown" in r.stdout
    assert _run(EXPLAIN, d, "--diff", a[:8], "nosuch", cwd=REPO) \
        .returncode == 2
    assert _run(EXPLAIN, str(os.path.dirname(d)) + "/none",
                cwd=REPO).returncode == 2


def test_library_key_is_unchanged_by_recording_its_parts():
    """The manifest's parts are what the key hashes: the key of a library
    is the one earlier builds stored (a cache stays warm across this)."""
    import hashlib
    src, tk = b"x", "V"
    old = hashlib.sha256(json.dumps(
        {"source": hashlib.sha256(src).hexdigest(), "flags": FLAGS,
         "nvcc": tk}, sort_keys=True).encode()).hexdigest()[:40]
    assert cc.library_key(src, FLAGS, tk) == old
    assert cc.key_parts(src, FLAGS, tk)["flags"] == FLAGS
