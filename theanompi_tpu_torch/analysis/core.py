"""The lint's framework: findings, one parse per file, the import resolver,
inline suppression, the runner and the baseline.

A checker is a class registered with :func:`register`.  :func:`run_lint`
parses every file in scope once into a :class:`SourceFile` (text, AST,
:class:`ImportResolver`, suppression map) and hands it to each checker
that applies: ``check_file`` for a per-file walk, ``check_program`` for
the whole-program pass over the shared :class:`~.engine.ProgramIndex`,
``check_project`` for a probe that runs once a run (live objects, files
read from disk).

The baseline (``tpulint_torch_baseline.json`` at the repo root) matches
findings by ``(check, path, message)``, never by line, as a multiset:
two identical findings need two entries.  It is written deterministically
(sorted, repo-relative POSIX paths) and every entry carries a one-line
justification.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: What a run with no paths walks: the port's runtime tree.
DEFAULT_PATHS = ("theanompi_tpu_torch", "chip_smoke.py")

BASELINE_NAME = "tpulint_torch_baseline.json"

_SUPPRESS_RE = re.compile(r"#\s*tpulint:\s*disable=([A-Za-z0-9_\-, ]+)")


@dataclass(frozen=True)
class Finding:
    """One hit.  ``fingerprint`` is what the baseline matches on; line and
    column are for the reader."""

    check: str
    path: str          # repo-relative, POSIX separators
    line: int
    col: int
    message: str

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.check, self.path, self.message)

    @property
    def stable_id(self) -> str:
        """12 hex characters of sha1 over ``check|path|message``: the same
        across edits that move the finding (the ``--format json`` and SARIF
        identity)."""
        return hashlib.sha1("|".join(self.fingerprint).encode()).hexdigest()[:12]

    def sort_key(self):
        return (self.path, self.line, self.col, self.check, self.message)

    def to_dict(self) -> dict:
        return {"check": self.check, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.check}] {self.message}"


class ImportResolver:
    """Absolute dotted names for the names of one module.

    ``import torch.distributed as dist`` binds ``dist`` to
    ``torch.distributed``; ``from ..utils import telemetry`` in
    ``theanompi_tpu_torch/parallel/steps.py`` binds ``telemetry`` to
    ``theanompi_tpu_torch.utils.telemetry``.  :meth:`resolve` turns a
    Name/Attribute chain into its dotted path, or None where the base is
    not an import (locals, ``self``, call results)."""

    def __init__(self, relpath: str, tree: ast.AST):
        stem = relpath[:-3] if relpath.endswith(".py") else relpath
        self.module = stem.replace("/", ".")
        self.package = self.module.rpartition(".")[0]
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    head = a.name.split(".")[0]
                    self.aliases[a.asname or head] = a.name if a.asname else head
            elif isinstance(node, ast.ImportFrom):
                base = self.resolve_from_module(node)
                if base is not None:
                    for a in node.names:
                        if a.name != "*":
                            self.aliases[a.asname or a.name] = f"{base}.{a.name}"

    def resolve_from_module(self, node: ast.ImportFrom) -> Optional[str]:
        """The absolute module of ``from X import ...``."""
        if node.level == 0:
            return node.module
        parts = self.package.split(".") if self.package else []
        up = node.level - 1
        if up > len(parts):
            return None
        base = parts[:len(parts) - up]
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base) if base else None

    def resolve(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    @staticmethod
    def dotted(node: ast.AST) -> Optional[str]:
        """The literal text of a Name/Attribute chain (``self.model.x``),
        whatever it is bound to."""
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            base = ImportResolver.dotted(node.value)
            return f"{base}.{node.attr}" if base else None
        return None


class SourceFile:
    """One parsed module: text, AST, resolver, suppression map."""

    def __init__(self, root: str, relpath: str, text: Optional[str] = None):
        self.root = root
        self.path = relpath.replace(os.sep, "/")
        if text is None:
            with open(os.path.join(root, relpath), encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        self.resolver = ImportResolver(self.path, self.tree)
        self._suppress: Dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                # on a line of its own the comment covers the next line
                target = i + 1 if not line.split("#", 1)[0].strip() else i
                self._suppress.setdefault(target, set()).update(
                    c.strip() for c in m.group(1).split(",") if c.strip())

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree (``ast.walk`` order), walked once."""
        nodes = self.__dict__.get("_nodes")
        if nodes is None:
            nodes = self.__dict__["_nodes"] = list(ast.walk(self.tree))
        return nodes

    def suppressed(self, line: int, check: str) -> bool:
        s = self._suppress.get(line, ())
        return check in s or "all" in s


CHECKERS: Dict[str, "Checker"] = {}


class Checker:
    """A registered check.  ``reads_files = False`` marks a project-only
    probe, so a run of it alone parses nothing; ``needs_engine`` asks for
    the shared :class:`~.engine.ProgramIndex`; ``disk_scoped`` lists the
    paths or glob patterns it reads beyond the files it is given, which
    key the result cache of partial runs."""

    name = "checker"
    description = ""
    reads_files = True
    needs_engine = False
    disk_scoped: Sequence[str] = ()

    def applies_to(self, path: str) -> bool:
        return True

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        return ()

    def check_program(self, index) -> Iterable[Finding]:
        return ()

    def check_project(self, files: List[SourceFile]) -> Iterable[Finding]:
        return ()


def register(cls):
    """Class decorator: add an instance to :data:`CHECKERS`."""
    inst = cls()
    assert inst.name not in CHECKERS, f"duplicate checker {inst.name!r}"
    CHECKERS[inst.name] = inst
    return cls


def select(only: Optional[Sequence[str]] = None,
           disable: Optional[Sequence[str]] = None) -> Dict[str, Checker]:
    """The checkers a run with ``--only``/``--disable`` runs; a KeyError
    names any unknown checker."""
    unknown = [n for n in list(only or []) + list(disable or [])
               if n not in CHECKERS]
    if unknown:
        raise KeyError(f"unknown checker(s) {unknown}; have {sorted(CHECKERS)}")
    return {n: c for n, c in CHECKERS.items()
            if (only is None or n in only)
            and (disable is None or n not in disable)}


def iter_py_paths(root: str, paths: Optional[Sequence[str]] = None) -> List[str]:
    """Repo-relative paths of every ``.py`` under ``paths`` (files or
    directories), sorted within each."""
    out: List[str] = []
    for p in (paths or DEFAULT_PATHS):
        full = os.path.join(root, p)
        if os.path.isfile(full):
            out.append(os.path.relpath(full, root))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__" and not d.startswith("."))
            out.extend(os.path.relpath(os.path.join(dirpath, fn), root)
                       for fn in sorted(filenames) if fn.endswith(".py"))
    return out


def collect_files(root: str, paths: Optional[Sequence[str]] = None
                  ) -> List[SourceFile]:
    """Every ``.py`` under ``paths``, parsed (a syntax error raises)."""
    return [SourceFile(root, rel) for rel in iter_py_paths(root, paths)]


def run_lint(root: str, paths: Optional[Sequence[str]] = None,
             only: Optional[Sequence[str]] = None,
             disable: Optional[Sequence[str]] = None,
             file_cache: Optional[Dict[str, List[Finding]]] = None,
             timings: Optional[Dict[str, float]] = None
             ) -> List[Finding]:
    """The selected checkers over the file set, findings sorted by path and
    line, suppressed ones dropped.  ``file_cache`` holds per-path findings
    of the file-scoped checkers from an earlier run over the same bytes:
    those paths skip ``check_file`` and take the cached findings.
    ``timings`` receives the CPU seconds of the parse (``parse``), of the
    engine's index (``index``) and of each checker."""
    clock = time.process_time
    timings = {} if timings is None else timings
    t0 = clock()
    selected = select(only, disable)
    files: List[SourceFile] = []
    findings: List[Finding] = []
    if any(c.reads_files for c in selected.values()):
        for rel in iter_py_paths(root, paths):
            try:
                files.append(SourceFile(root, rel))
            except SyntaxError as e:
                findings.append(Finding("parse-error", rel.replace(os.sep, "/"),
                                        int(e.lineno or 1), 0,
                                        f"cannot parse: {e.msg}"))
    timings["parse"] = clock() - t0
    index = None
    if files and any(c.needs_engine for c in selected.values()):
        from .engine import ProgramIndex
        t0 = clock()
        index = ProgramIndex(files)
        timings["index"] = clock() - t0

    by_path = {sf.path: sf for sf in files}
    cached = set(file_cache or ())

    def keep(f: Finding) -> bool:
        sf = by_path.get(f.path)
        return sf is None or not sf.suppressed(f.line, f.check)

    for name in sorted(selected):
        checker = selected[name]
        t0 = clock()
        for sf in files:
            if sf.path not in cached and checker.applies_to(sf.path):
                findings.extend(f for f in checker.check_file(sf) if keep(f))
        if index is not None and checker.needs_engine:
            findings.extend(f for f in checker.check_program(index) if keep(f))
        findings.extend(f for f in checker.check_project(files) if keep(f))
        timings[name] = clock() - t0
    for path in cached & set(by_path):
        findings.extend(f for f in file_cache[path]
                        if f.check in selected or f.check == "parse-error")
    findings.sort(key=Finding.sort_key)
    return findings


def file_scoped_checkers(selected: Optional[Dict[str, Checker]] = None
                         ) -> List[str]:
    """Checkers whose findings are a function of one file alone (they
    override ``check_file``): what the per-file cache may keep."""
    pool = CHECKERS if selected is None else selected
    return sorted(n for n, c in pool.items()
                  if type(c).check_file is not Checker.check_file)


def load_baseline(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return list(json.load(f).get("entries", []))


def _key(entry: dict) -> Tuple:
    return (entry.get("check"), entry.get("path"), entry.get("message"))


def save_baseline(path: str, findings: Sequence[Finding],
                  old_entries: Sequence[dict] = ()) -> List[dict]:
    """Write the baseline sorted by (check, path, message, line), keeping
    the justifications of entries that still match."""
    just: Dict[Tuple, List[str]] = {}
    for e in old_entries:
        just.setdefault(_key(e), []).append(e.get("justification", "TODO: justify"))
    entries = []
    for f in sorted(findings, key=lambda f: (f.check, f.path, f.message, f.line)):
        pool = just.get(f.fingerprint)
        entries.append({"check": f.check, "path": f.path, "line": f.line,
                        "message": f.message,
                        "justification": pool.pop(0) if pool else "TODO: justify"})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return entries


def compare_baseline(findings: Sequence[Finding], entries: Sequence[dict]
                     ) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """``(new, baselined, stale)``: findings the baseline lacks, findings
    it covers, and entries that match nothing."""
    pool: Dict[Tuple, List[dict]] = {}
    for e in entries:
        pool.setdefault(_key(e), []).append(e)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        bucket = pool.get(f.fingerprint)
        if bucket:
            bucket.pop()
            matched.append(f)
        else:
            new.append(f)
    return new, matched, [e for bucket in pool.values() for e in bucket]
