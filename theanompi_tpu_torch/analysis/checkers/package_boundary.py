"""package-boundary: the port never reaches the JAX world.

Counterpart of the JAX lint's compat-boundary, which routes
``shard_map``/``pvary``/``pcast`` through one shim; the port has no shim
to guard, but the boundary it lives by is sharper: nothing of it imports
``jax``, ``jaxlib`` or the JAX package (``theanompi_tpu`` without
``_torch``), so it runs on a machine without them.  Flagged, anywhere in
the port's tree and ``chip_smoke.py``:

* an ``import``/``from … import`` of those, at module level or inside a
  function (``tests/test_torch_no_jax.py`` sees only what runs at import
  time);
* ``importlib.import_module("<name>")`` and ``__import__("<name>")`` with
  a literal name of those;
* a ``sys.path`` insertion whose literal path names the JAX package or
  JAX.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..core import Checker, Finding, SourceFile, register

BANNED_ROOTS = ("jax", "jaxlib", "theanompi_tpu")


def banned_module(name: Optional[str]) -> Optional[str]:
    """The banned root ``name`` lies under, or None."""
    if not name:
        return None
    root = name.split(".")[0]
    return root if root in BANNED_ROOTS else None


def _path_names_jax(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            parts = n.value.replace("\\", "/").split("/")
            if any(p in BANNED_ROOTS for p in parts):
                return True
    return False


@register
class PackageBoundaryChecker(Checker):
    name = "package-boundary"
    description = ("no import of jax, jaxlib or the JAX package (module "
                   "level, function-local, importlib, __import__) and no "
                   "sys.path entry for them")

    def check_file(self, sf: SourceFile):
        findings: List[Finding] = []

        def emit(node, msg):
            findings.append(Finding(self.name, sf.path, node.lineno,
                                    node.col_offset, msg))

        for node in sf.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if banned_module(a.name):
                        emit(node, f"import of `{a.name}`: the port imports "
                                   f"nothing of jax, jaxlib or the JAX "
                                   f"package")
            elif isinstance(node, ast.ImportFrom):
                base = sf.resolver.resolve_from_module(node)
                if node.level == 0 and banned_module(base):
                    emit(node, f"import from `{base}`: the port imports "
                               f"nothing of jax, jaxlib or the JAX package")
            elif isinstance(node, ast.Call):
                resolved = sf.resolver.resolve(node.func)
                f = node.func
                dynamic = resolved == "importlib.import_module" or (
                    isinstance(f, ast.Name) and f.id == "__import__")
                if dynamic and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, str) and \
                        banned_module(node.args[0].value):
                    emit(node, f"dynamic import of `{node.args[0].value}`: "
                               f"the port imports nothing of jax, jaxlib or "
                               f"the JAX package")
                elif resolved in ("sys.path.insert", "sys.path.append") and \
                        any(_path_names_jax(a) for a in node.args):
                    emit(node, "sys.path entry for the JAX package: the port "
                               "runs without it")
        return findings
