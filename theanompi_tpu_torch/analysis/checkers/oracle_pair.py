"""oracle-pair: every CUDA kernel of ``ops/`` keeps its plain version, its
CPU test and its card comparison.

Each hand-written kernel of the port comes as a triple: a wrapper that
launches it, a plain PyTorch function of the same result (what a CPU
tensor runs, and what the card's output is held to), a CPU test in
``tests/test_torch_*.py`` that holds the plain function to the JAX
reference, and a row of ``chip_smoke.py``'s ``kernel_rows()`` that holds
the kernel to its plain version on the card.  This checker keeps the
triple whole, statically:

* a **loader** is a module function that calls
  ``_kernel_build.load`` (the ``_lib()`` helpers); a **launcher** calls a
  loader;
* a **kernel wrapper** is a function that reaches a launcher through
  private (``_``-named) helpers only, and that no other such function
  reaches (``flash_fwd_cuda`` → ``_fwd`` → ``_lib``; ``_fwd`` itself is
  a helper);
* every kernel wrapper has an entry in the module's ``CUDA_PLAINS`` dict,
  a literal ``{wrapper: plain}`` read with ``ast.literal_eval``; the plain
  function is defined in the module; some ``tests/test_torch_*.py``
  names it; and the wrapper, or a public function of the module that
  reaches it, is named in ``kernel_rows()``;
* an entry that names no kernel wrapper is stale;
* a function handed to ``_kernel_build.route`` as the CUDA side must
  reach a kernel wrapper the checker can see, so that the path a CUDA
  tensor takes is held to the same triple.

"Reaches" follows the names a function's body loads: calls, references
passed on (``route(..., plain, kernel)``) and selections alike.  The
checker reads ``ops/``, the tests and ``chip_smoke.py`` from disk, not
from the files it is given, so that deleting a test fails a partial run
too.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, SourceFile, register

OPS_GLOB = os.path.join("theanompi_tpu_torch", "ops", "*.py")
TESTS_GLOB = os.path.join("tests", "test_torch_*.py")
SMOKE_PATH = "chip_smoke.py"
ROWS_FN = "kernel_rows"
LOAD_FN = "theanompi_tpu_torch.ops._kernel_build.load"
ROUTE_FN = "theanompi_tpu_torch.ops._kernel_build.route"
REGISTRY_NAME = "CUDA_PLAINS"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def _functions(sf: SourceFile) -> Dict[str, ast.AST]:
    """The module's top-level functions by name."""
    return {n.name: n for n in sf.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _refs(fn: ast.AST, names: Set[str]) -> Set[str]:
    """Module functions whose names ``fn``'s body loads."""
    return {n.id for n in ast.walk(fn)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            and n.id in names} - {getattr(fn, "name", None)}


def _calls(fn: ast.AST, sf: SourceFile, dotted: str) -> List[ast.Call]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and sf.resolver.resolve(n.func) == dotted]


class KernelModule:
    """The kernel structure of one ops module."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.funcs = _functions(sf)
        names = set(self.funcs)
        self.refs = {n: _refs(f, names) for n, f in self.funcs.items()}
        self.loaders = {n for n, f in self.funcs.items()
                        if _calls(f, sf, LOAD_FN)}
        self.launchers = {n for n, r in self.refs.items()
                          if r & self.loaders and n not in self.loaders}
        # reaches a launcher through private helpers only
        private = {n for n in names if n.startswith("_")}
        launching = set(self.launchers)
        changed = True
        while changed:
            changed = False
            for n, r in self.refs.items():
                if n not in launching and n not in self.loaders and \
                        r & launching & private:
                    launching.add(n)
                    changed = True
        self.wrappers = {n for n in launching
                         if not any(n in self.refs[m]
                                    for m in launching if m != n)}

    def reaches(self, name: str) -> Set[str]:
        """Every module function ``name`` reaches (itself excluded)."""
        out: Set[str] = set()
        frontier = [name]
        while frontier:
            for m in self.refs.get(frontier.pop(), ()):
                if m not in out:
                    out.add(m)
                    frontier.append(m)
        out.discard(name)
        return out

    def public_reaching(self, name: str) -> Set[str]:
        return {n for n in self.funcs
                if not n.startswith("_") and name in self.reaches(n)}

    def registry(self) -> Tuple[Optional[Dict[str, str]], int]:
        """The ``CUDA_PLAINS`` literal and its line: ``(None, 1)`` when
        absent, ``(None, line)`` when not a ``{str: str}`` literal."""
        for node in self.sf.tree.body:
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target] if isinstance(node, ast.AnnAssign) else []
            if not any(isinstance(t, ast.Name) and t.id == REGISTRY_NAME
                       for t in targets):
                continue
            try:
                val = ast.literal_eval(node.value)
            except (ValueError, TypeError):
                return None, node.lineno
            if isinstance(val, dict) and all(
                    isinstance(k, str) and isinstance(v, str)
                    for k, v in val.items()):
                return val, node.lineno
            return None, node.lineno
        return None, 1

    def route_sites(self) -> List[Tuple[ast.Call, Optional[str]]]:
        """``(call, kernel-side name)`` of every ``_kernel_build.route``
        call; the name is None when the argument is not a module
        function."""
        out = []
        for node in ast.walk(self.sf.tree):
            if isinstance(node, ast.Call) and \
                    self.sf.resolver.resolve(node.func) == ROUTE_FN:
                arg = node.args[3] if len(node.args) > 3 else None
                for kw in node.keywords:
                    if kw.arg == "kernel":
                        arg = kw.value
                out.append((node, arg.id if isinstance(arg, ast.Name)
                            and arg.id in self.funcs else None))
        return out


def _read(path: str) -> Optional[str]:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _named(name: str, text: str) -> bool:
    return re.search(r"(?<![\w])%s(?![\w])" % re.escape(name), text) is not None


def compared_names(root: str) -> Optional[Set[str]]:
    """The names ``chip_smoke.py``'s ``kernel_rows()`` refers to (names and
    attributes, not the strings of its labels), or None without the
    file."""
    text = _read(os.path.join(root, SMOKE_PATH))
    if text is None:
        return None
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return None
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == ROWS_FN:
            return {n.id if isinstance(n, ast.Name) else n.attr
                    for n in ast.walk(node)
                    if isinstance(n, (ast.Name, ast.Attribute))}
    return set()


def oracle_pair_findings(root: str, check_name: str = "oracle-pair"
                         ) -> List[Finding]:
    """The audit of a tree at ``root`` (tests run it on trees of their
    own)."""
    findings: List[Finding] = []
    tests = [t for t in (_read(p) for p in sorted(
        glob.glob(os.path.join(root, TESTS_GLOB)))) if t is not None]
    rows = compared_names(root)
    for path in sorted(glob.glob(os.path.join(root, OPS_GLOB))):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            km = KernelModule(SourceFile(root, rel))
        except (SyntaxError, OSError):
            continue                    # the parse step reports it
        registry, reg_line = km.registry()
        if not km.wrappers and registry is None:
            continue

        def hit(line, message):
            findings.append(Finding(check_name, rel, line, 0, message))

        if registry is None:
            hit(reg_line if reg_line > 1 else
                min(km.funcs[w].lineno for w in km.wrappers),
                f"module launches CUDA kernels but declares no pure-literal "
                f"{REGISTRY_NAME} dict mapping each kernel wrapper to its "
                f"plain version")
            continue
        for w in sorted(km.wrappers - set(registry)):
            hit(km.funcs[w].lineno,
                f"kernel wrapper `{w}` has no {REGISTRY_NAME} entry — its "
                f"plain version (the CPU path and the card's reference) is "
                f"unpinned")
        for wrapper, plain in sorted(registry.items()):
            if wrapper not in km.wrappers:
                hit(reg_line, f"{REGISTRY_NAME} entry `{wrapper}` names no "
                              f"function launching a CUDA kernel in this "
                              f"module — stale registry entry")
                continue
            if plain not in km.funcs:
                hit(reg_line, f"{REGISTRY_NAME} maps `{wrapper}` to "
                              f"`{plain}`, which is not defined in this "
                              f"module")
                continue
            if tests and not any(_named(plain, t) for t in tests):
                hit(reg_line, f"no tests/test_torch_*.py file names "
                              f"`{plain}` — the plain version of `{wrapper}` "
                              f"is not held to the JAX reference on the CPU")
            shown = {wrapper} | km.public_reaching(wrapper)
            if rows is not None and not shown & rows:
                hit(km.funcs[wrapper].lineno,
                    f"kernel wrapper `{wrapper}` is not in chip_smoke.py's "
                    f"{ROWS_FN}() — the kernel is never held to `{plain}` "
                    f"on the card")
        for call, kernel in km.route_sites():
            if kernel is None or not ({kernel} | km.reaches(kernel)) & \
                    km.wrappers:
                hit(call.lineno, f"_kernel_build.route hands CUDA tensors to "
                                 f"`{kernel or '<expression>'}`, which "
                                 f"reaches no kernel wrapper this checker "
                                 f"can see — that path escapes the "
                                 f"plain/test/card triple")
    return findings


@register
class OraclePairChecker(Checker):
    name = "oracle-pair"
    description = ("every CUDA kernel wrapper in ops/ must be registered "
                   "in its module's CUDA_PLAINS dict with a plain version "
                   "defined there, named by a tests/test_torch_*.py file "
                   "(the CPU test) and compared on the card in "
                   "chip_smoke.py's kernel_rows()")
    reads_files = False    # reads ops/, the tests and chip_smoke from disk
    disk_scoped = (OPS_GLOB, TESTS_GLOB, SMOKE_PATH)

    def check_project(self, files) -> List[Finding]:
        return oracle_pair_findings(files[0].root if files else _repo_root(),
                                    self.name)
