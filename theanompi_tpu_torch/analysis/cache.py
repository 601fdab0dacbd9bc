"""The lint's result cache, in ``.tpulint_torch_cache/`` at the repo root.

Two kinds of entry, each keyed so that a stale hit cannot happen:

* a **tree** entry holds every finding of one run, keyed on sha256 over
  the analysis fingerprint, the checkers selected, the path arguments and
  the content hash of every file in scope: an unchanged tree costs one
  pass of hashing and one JSON read;
* a **file** entry holds the findings of the file-scoped checkers for one
  file's bytes.  On a tree miss, unchanged files take their cached
  findings; the whole-program and project checkers always run.

The analysis fingerprint hashes every source of this package, so an edit
to any checker, the engine or this module invalidates everything.  Writes
go through a temporary file and a rename, and any failure of the store
reads as a miss: the cache can make a run slower, never wrong.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import List, Optional, Sequence, Tuple

from .core import Finding

CACHE_DIR_NAME = ".tpulint_torch_cache"
SCHEMA = 1                 # the layout of an entry
_KEEP = {"tree": 64, "files": 4096}   # newest entries kept per kind


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def analysis_fingerprint() -> str:
    """sha256 over every ``.py`` of this package."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(here):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(f for f in filenames if f.endswith(".py")):
            h.update(os.path.relpath(os.path.join(dirpath, fn), here).encode())
            with open(os.path.join(dirpath, fn), "rb") as f:
                h.update(_sha(f.read()).encode())
    return h.hexdigest()


def file_hashes(root: str, rels: Sequence[str]) -> List[Tuple[str, str]]:
    """(repo-relative path, content sha256) of each file; a file that cannot
    be read gets a marker no hash equals."""
    out = []
    for rel in rels:
        key = rel.replace(os.sep, "/")
        try:
            with open(os.path.join(root, rel), "rb") as f:
                out.append((key, _sha(f.read())))
        except OSError:
            out.append((key, f"unreadable:{rel}"))
    return out


def _key(payload: dict) -> str:
    return _sha(json.dumps(dict(payload, schema=SCHEMA), sort_keys=True).encode())


def tree_key(analysis_fp: str, checker_names: Sequence[str],
             path_args: Sequence[str], hashes: Sequence[Tuple[str, str]]) -> str:
    return _key({"analysis": analysis_fp, "checkers": sorted(checker_names),
                 "paths": list(path_args), "files": sorted(hashes)})


def file_key(analysis_fp: str, file_checkers: Sequence[str],
             content_sha: str) -> str:
    return _key({"analysis": analysis_fp, "checkers": sorted(file_checkers),
                 "sha": content_sha})


class LintCache:
    """The store under ``<root>/.tpulint_torch_cache`` or ``cache_dir``."""

    def __init__(self, root: str, cache_dir: Optional[str] = None):
        self.dir = cache_dir or os.path.join(root, CACHE_DIR_NAME)

    def _path(self, kind: str, key: str) -> str:
        return os.path.join(self.dir, kind, key[:32] + ".json")

    def load(self, kind: str, key: str) -> Optional[List[Finding]]:
        try:
            with open(self._path(kind, key), encoding="utf-8") as f:
                data = json.load(f)
            if data.get("schema") != SCHEMA:
                return None
            return [Finding(d["check"], d["path"], d["line"], d["col"],
                            d["message"]) for d in data["findings"]]
        except (OSError, KeyError, TypeError, ValueError):
            return None

    def store(self, kind: str, key: str, findings: Sequence[Finding]) -> None:
        try:
            d = os.path.join(self.dir, kind)
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump({"schema": SCHEMA,
                           "findings": [x.to_dict() for x in findings]}, f)
            os.replace(tmp, self._path(kind, key))
            self._prune(d, _KEEP[kind])
        except OSError:
            pass

    @staticmethod
    def _prune(d: str, keep: int) -> None:
        try:
            entries = sorted((e.stat().st_mtime, e.path) for e in os.scandir(d)
                             if e.name.endswith(".json"))
        except OSError:
            return
        for _, path in entries[:max(0, len(entries) - keep)]:
            try:
                os.unlink(path)
            except OSError:
                pass
