"""The lint's command line (``python -m theanompi_tpu_torch.tools.lint``).

* With no flags: run the checks over the port's tree and print the
  findings; a finding the baseline lacks fails (exit 1), a stale
  baseline entry only warns.
* ``--check-baseline``: a stale entry fails too, so the committed
  baseline stays exact (the gate the tests and ``chip_smoke.py`` run).
* ``--update-baseline``: rewrite ``tpulint_torch_baseline.json``
  (sorted, repo-relative), keeping the justifications of the entries that
  remain; a new entry gets ``TODO: justify``.
* ``--format json`` (or ``--json``): the findings with a stable
  ``fingerprint`` each, the baseline delta, the cache status and the CPU
  seconds of the parse, the index and each check that ran (none on a
  cache hit);
  ``--format sarif``: a SARIF 2.1.0 log of the new findings.
* ``--only``/``--disable``: checker names, the groups ``concurrency``,
  ``protocol``, ``spmd`` and ``compile-surface``, or a JAX check's name
  (its port counterpart), comma-separated; ``--list-checks`` prints the
  checks and each JAX check beside its counterpart.
* ``--diff REF``: only the ``.py`` files changed against a git ref
  (``CACHED``: the staged index against HEAD), within the lint's paths.
  A partial run judges no baseline entry stale and cannot rewrite the
  baseline.
* ``--no-cache``: skip the result cache in ``.tpulint_torch_cache/``
  (``--cache-dir`` moves it).
* ``--verbose``: list each baseline entry still marked TODO.

Exit codes: 0 clean, 1 findings or baseline drift, 2 a bad invocation.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

from . import cache as cache_mod
from .checkers import CHECK_GROUPS, JAX_COUNTERPARTS
from .core import (BASELINE_NAME, CHECKERS, DEFAULT_PATHS, Finding,
                   compare_baseline, file_scoped_checkers, iter_py_paths,
                   load_baseline, run_lint, save_baseline, select)


def _repo_root() -> str:
    # <root>/theanompi_tpu_torch/analysis/cli.py
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _split(value: Optional[str]) -> Optional[List[str]]:
    """Comma-split, groups expanded, duplicates dropped in order."""
    if value is None:
        return None
    out: List[str] = []
    for v in (v.strip() for v in value.split(",")):
        v = JAX_COUNTERPARTS.get(v, v)
        for name in CHECK_GROUPS.get(v, (v,) if v else ()):
            if name not in out:
                out.append(name)
    return out


def _lint_scope(path: str) -> bool:
    return any(path == d or path.startswith(d.rstrip("/") + "/")
               for d in DEFAULT_PATHS)


def _git_changed(root: str, ref: str):
    """``.py`` paths changed against ``ref`` (deletions left out), as
    ``(paths, None)`` or ``(None, error)``.  Git runs in ``root`` when it
    is a checkout, else in the current directory."""
    git_root = root if os.path.exists(os.path.join(root, ".git")) \
        else os.getcwd()
    cmd = ["git", "-C", git_root, "diff", "--name-only", "--diff-filter=d",
           "--cached" if ref == "CACHED" else ref, "--", "*.py"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"git unavailable ({e!r})"
    if out.returncode != 0:
        return None, (out.stderr.strip().splitlines() or
                      [f"git diff exited {out.returncode}"])[-1]
    return [ln.strip().replace(os.sep, "/")
            for ln in out.stdout.splitlines() if ln.strip()], None


def _disk_extra(root: str, selected: List[str], lint_rels) -> List[str]:
    """The files the selected checkers read beyond the lint's own set:
    they key the tree cache, but get no per-file entry (they were not
    linted)."""
    extra: List[str] = []
    for name in selected:
        for pat in CHECKERS[name].disk_scoped:
            if any(ch in pat for ch in "*?["):
                probes = sorted(os.path.relpath(m, root).replace(os.sep, "/")
                                for m in glob.glob(os.path.join(root, pat))
                                if m.endswith(".py"))
            else:
                probes = [pat]
            extra += [p for p in probes
                      if p not in lint_rels and p not in extra
                      and os.path.exists(os.path.join(root, p))]
    return extra


def _cached_run(root, paths, only, disable, cache_dir=None, timings=None):
    """The checks through the result cache: ``(findings, status)``, the
    status ``hit`` or ``miss``."""
    selected = sorted(select(only, disable))
    rels = iter_py_paths(root, paths)
    lint_rels = {r.replace(os.sep, "/") for r in rels}
    hashes = cache_mod.file_hashes(
        root, list(rels) + _disk_extra(root, selected, lint_rels))
    afp = cache_mod.analysis_fingerprint()
    store = cache_mod.LintCache(root, cache_dir)
    tkey = cache_mod.tree_key(afp, selected, list(paths or []), hashes)
    cached = store.load("tree", tkey)
    if cached is not None:
        return cached, "hit"
    fsc = [n for n in file_scoped_checkers() if n in selected]
    fkeys = {rel: cache_mod.file_key(afp, fsc, sha) for rel, sha in hashes}
    file_cache: Dict[str, List[Finding]] = {}
    for rel, key in fkeys.items():
        hit = store.load("files", key)
        if hit is not None:
            file_cache[rel] = hit
    findings = run_lint(root, paths=paths, only=only, disable=disable,
                        file_cache=file_cache or None, timings=timings)
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        if f.check in fsc:
            by_path.setdefault(f.path, []).append(f)
    for rel, key in fkeys.items():
        if rel not in file_cache and rel in lint_rels:
            store.store("files", key, by_path.get(rel, []))
    store.store("tree", tkey, findings)
    return findings, "miss"


def _sarif_log(new: List[Finding]) -> dict:
    """SARIF 2.1.0 over the new findings, each with its stable id."""
    rules = [{"id": rid, "shortDescription": {
        "text": CHECKERS[rid].description if rid in CHECKERS else rid}}
        for rid in sorted({f.check for f in new})]
    results = [{
        "ruleId": f.check,
        "level": "error",
        "message": {"text": f.message},
        "locations": [{"physicalLocation": {
            "artifactLocation": {"uri": f.path},
            "region": {"startLine": max(f.line, 1),
                       "startColumn": max(f.col + 1, 1)}}}],
        "partialFingerprints": {"tpulintFingerprint/v1": f.stable_id},
    } for f in new]
    return {"$schema": "https://json.schemastore.org/sarif-2.1.0.json",
            "version": "2.1.0",
            "runs": [{"tool": {"driver": {"name": "tpulint-torch",
                                          "rules": rules}},
                      "results": results}]}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.tools.lint",
        description="whole-program checks of the port's host code")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the port's tree)")
    ap.add_argument("--root", default=None,
                    help="repository root (default: this checkout)")
    ap.add_argument("--format", default=None, dest="fmt",
                    choices=("human", "json", "sarif"))
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="the same as --format json")
    ap.add_argument("--only", default=None,
                    help="checkers or groups to run, comma-separated")
    ap.add_argument("--disable", default=None,
                    help="checkers or groups to skip, comma-separated")
    ap.add_argument("--diff", default=None, metavar="REF",
                    help="only .py files changed against a git ref "
                         "(CACHED: the staged index)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--check-baseline", action="store_true",
                    help="fail on stale baseline entries too")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the result cache")
    ap.add_argument("--cache-dir", default=None,
                    help=f"cache directory (default: <root>/"
                         f"{cache_mod.CACHE_DIR_NAME})")
    ap.add_argument("--verbose", action="store_true",
                    help="list every baseline entry marked TODO")
    ap.add_argument("--list-checks", action="store_true")
    return ap


def _err(msg: str) -> int:
    print(f"lint: {msg}", file=sys.stderr)
    return 2


_FULL_RUN = "--update-baseline requires a full run (no paths/--diff/--only/--disable)"


def main(argv: Optional[List[str]] = None) -> int:
    try:
        args = _parser().parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0
    if args.list_checks:
        for name in sorted(CHECKERS):
            print(f"{name}: {CHECKERS[name].description}")
        print("\nthe JAX lint's checks and their port counterparts:")
        for name in sorted(set(CHECKERS) - set(JAX_COUNTERPARTS.values())
                           | set(JAX_COUNTERPARTS)):
            print(f"  {name} -> {JAX_COUNTERPARTS.get(name, name)}")
        return 0
    root = os.path.abspath(args.root or _repo_root())
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    if args.diff:
        if args.paths:
            return _err("--diff and explicit paths are mutually exclusive")
        if args.update_baseline:
            return _err(_FULL_RUN)
        changed, err = _git_changed(root, args.diff)
        if changed is None:
            return _err(f"--diff {args.diff}: {err}")
        args.paths = sorted({p for p in changed if p.endswith(".py")
                             and _lint_scope(p)
                             and os.path.exists(os.path.join(root, p))})
        if not args.paths:
            print(f"lint: no changed python files in lint scope vs {args.diff}")
            return 0
    missing = [p for p in args.paths if not os.path.exists(os.path.join(root, p))]
    if missing:
        return _err(f"no such path(s): {', '.join(missing)}")
    only, disable = _split(args.only), _split(args.disable)
    timings: Dict[str, float] = {}
    try:
        if args.no_cache:
            findings = run_lint(root, paths=args.paths or None, only=only,
                                disable=disable, timings=timings)
            cache_status = "off"
        else:
            findings, cache_status = _cached_run(
                root, args.paths or None, only, disable, args.cache_dir,
                timings)
    except KeyError as e:
        return _err(e.args[0])

    entries = load_baseline(baseline_path)
    # staleness means something only on a full run
    partial = bool(args.paths or args.only or args.disable)
    new, matched, stale = compare_baseline(findings, entries)
    if partial:
        stale = []
    if args.update_baseline:
        if partial:
            return _err(_FULL_RUN)
        saved = save_baseline(baseline_path, findings, entries)
        print(f"tpulint: baseline written to "
              f"{os.path.relpath(baseline_path, root)} ({len(saved)} entries)")
        todo = sum(e["justification"].startswith("TODO") for e in saved)
        if todo:
            print(f"tpulint: {todo} entries need a justification (edit the "
                  f"file)", file=sys.stderr)
        return 0

    todo = [e for e in entries
            if str(e.get("justification", "")).startswith("TODO")]
    if todo and args.verbose:
        for e in todo:
            print(f"baseline entry needs a justification: {e.get('check')}: "
                  f"{e.get('path')}: {e.get('message')}", file=sys.stderr)
    elif todo:
        n = len(todo)
        print(f"tpulint: {n} baseline entr{'y' if n == 1 else 'ies'} with a "
              f"TODO placeholder — each needs a justification (--verbose "
              f"lists them)", file=sys.stderr)

    if args.fmt == "sarif":
        print(json.dumps(_sarif_log(new), indent=2, sort_keys=True))
    elif args.as_json or args.fmt == "json":
        def enrich(f: Finding) -> dict:
            return dict(f.to_dict(), fingerprint=f.stable_id)

        print(json.dumps({"version": 2,
                          "findings": [enrich(f) for f in findings],
                          "new": [enrich(f) for f in new],
                          "baselined": len(matched),
                          "stale_baseline": stale,
                          "cache": cache_status,
                          "cpu_seconds": {k: round(v, 3)
                                          for k, v in timings.items()}},
                         indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"stale baseline entry: {e.get('check')}: {e.get('path')}: "
                  f"{e.get('message')}", file=sys.stderr)
        print(f"tpulint: {len(findings)} finding(s) — {len(new)} new, "
              f"{len(matched)} baselined, {len(stale)} stale baseline "
              f"entr(ies) [cache {cache_status}]")
    if new or (stale and args.check_baseline):
        return 1
    return 0
