"""rng-discipline: every draw from a stream of its own.

Counterpart of the JAX lint's rng-discipline, redesigned for stateful
``torch.Generator`` objects.  The JAX bug is one key feeding two draws: both
come out bit-identical.  Its torch forms:

* **one seed spent twice.**  ``manual_seed(s)`` spends the Name ``s`` as
  JAX spends a key: a second ``manual_seed(s)`` (of any generator, or
  the global one) with no rebinding of ``s`` between starts a second
  stream with the first one's bits.  A loop that seeds from a Name it
  never rebinds replays one stream every iteration.  A seed derived in
  the call (``manual_seed(step_seed(tag, seed, count))``) spends
  nothing: seeding a fresh generator per step from a distinct tuple is
  the sanctioned shape, as ``fold_in`` is in JAX.  Interprocedural: a
  call to a function that seeds from one of its parameters (directly or
  through its callees, a fixpoint over the engine's call graph) spends
  the Name passed there.  Exclusive arms of a branch analyse against a
  copy of the state.
* **two streams under one tag.**  ``step_seed`` call sites in different
  functions whose leading argument is the same constant (a literal, or
  a module constant such as ``exchanger._GATE_TAG``) draw one stream
  twice: every stream needs a tag of its own.
* **a draw from the global generator** in library code: ``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial``, dropout and the in-place ``normal_``/``uniform_``/…
  without ``generator=``.  What it draws depends on every draw anything
  else in the process made before it (and a CUDA graph freezes it).
* **global seeding** in library code: ``torch.manual_seed``,
  ``torch.cuda.manual_seed(_all)``, ``np.random.seed``, ``random.seed``
  reseed every stream of the process behind its other users' backs.

Library code is every file outside ``tests/``.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from ..core import Checker, Finding, SourceFile, register
from ..engine import (GLOBAL_SEEDS, ProgramIndex, consumed_seed_name,
                      draw_name, has_generator)

#: the port's seed derivation (``parallel/steps.step_seed``)
STEP_SEED = "step_seed"

_BLOCK_FIELDS = ("body", "orelse", "finalbody")


@register
class RngDisciplineChecker(Checker):
    name = "rng-discipline"
    description = ("one seed spent by two manual_seed calls (or in a loop); "
                   "two step_seed streams under one tag; draws without "
                   "generator= and global seeding in library code")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        out: List[Finding] = []
        for sf in index.files:
            out.extend(self._check_file(index, sf))
            if not sf.path.startswith("tests/"):
                out.extend(self._library(sf))
        out.extend(self._tags(index))
        return out

    def _library(self, sf: SourceFile):
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            resolved = sf.resolver.resolve(node.func)
            if resolved in GLOBAL_SEEDS:
                yield Finding(
                    self.name, sf.path, node.lineno, node.col_offset,
                    f"global seeding `{resolved}()` in library code — it "
                    f"reseeds every other user's stream; seed a "
                    f"torch.Generator of your own")
                continue
            d = draw_name(node, sf.resolver)
            if d is not None and not has_generator(node):
                yield Finding(
                    self.name, sf.path, node.lineno, node.col_offset,
                    f"draw `{d}` without generator= in library code — it "
                    f"draws from the process's global stream, which "
                    f"every other draw moves")

    def _tags(self, index: ProgramIndex):
        """``step_seed`` call sites sharing a constant leading tag across
        functions."""
        first: Dict[object, tuple] = {}
        for sf in index.files:
            consts = {k.rsplit(".", 1)[-1]: v
                      for k, v in index._module_constants.items()
                      if k.startswith(sf.resolver.module + ".")}
            fidx = index.file_index[sf.path]
            if STEP_SEED not in sf.text:
                continue
            for node in sf.nodes:
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                f = node.func
                fname = f.attr if isinstance(f, ast.Attribute) else \
                    getattr(f, "id", None)
                if fname != STEP_SEED:
                    continue
                tag = self._tag_value(index, sf, node.args[0], consts)
                if tag is None:
                    continue
                where = fidx.enclosing.get(id(node))
                seen = first.get(tag)
                if seen is None:
                    first[tag] = (sf.path, node.lineno, id(where))
                elif seen[2] != id(where):
                    yield Finding(
                        self.name, sf.path, node.lineno, node.col_offset,
                        f"step_seed stream tag {tag!r} is also the tag of "
                        f"the stream seeded at {seen[0]}:{seen[1]} — two "
                        f"streams under one tag draw the same bits; give "
                        f"each stream a tag of its own")

    @staticmethod
    def _tag_value(index, sf, arg, consts):
        if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, (int, str)):
            return arg.value
        if isinstance(arg, ast.Name) and arg.id in consts:
            return consts[arg.id]
        resolved = sf.resolver.resolve(arg) if isinstance(
            arg, (ast.Name, ast.Attribute)) else None
        if resolved:
            return index.module_constant(resolved)
        return None

    def _check_file(self, index: ProgramIndex, sf: SourceFile):
        self._index = index
        self._sf = sf
        self._fidx = index.file_index[sf.path]
        findings: List[Finding] = []
        spenders = self._spender_names(index)
        for node in sf.nodes:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)) or \
                    not self._spends(index, node, spenders):
                continue          # spends no seed: nothing to reuse
            if isinstance(node, ast.Lambda):
                self._scan_exprs(sf, node.body, {}, findings)
            else:
                self._scan_block(sf, self._stmts(node), {}, findings)
        # one diagnostic per call site (the loop walk and the linear walk
        # can both describe the same reuse)
        seen, out = set(), []
        for f in findings:
            if (f.line, f.col) not in seen:
                seen.add((f.line, f.col))
                out.append(f)
        return out

    def _spender_names(self, index: ProgramIndex) -> set:
        """Simple names of the functions that spend a parameter as a
        seed."""
        cached = getattr(index, "_rng_spenders", None)
        if cached is None:
            cached = {r.name for r in index.records.values()
                      if index.seed_params(r)}
            index._rng_spenders = cached
        return cached

    @staticmethod
    def _spends(index: ProgramIndex, fn, spenders: set) -> bool:
        for sub in ast.walk(fn) if isinstance(fn, ast.Lambda) \
                else index.body(fn):
            if isinstance(sub, ast.Call):
                f = sub.func
                name = f.attr if isinstance(f, ast.Attribute) else \
                    getattr(f, "id", None)
                if name == "manual_seed" or name in spenders:
                    return True
        return False

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _stmts(fn):
        body = getattr(fn, "body", None)
        return body if isinstance(body, list) else []

    def _key_names(self, sf: SourceFile, call: ast.Call) -> List[str]:
        """Names spent as seeds by this call: the seed of a direct
        ``manual_seed(<name>)``, plus every Name passed at a position the
        (engine-resolved) callee spends as a seed."""
        direct = consumed_seed_name(call, sf.resolver)
        if direct is not None:
            return [direct]
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "manual_seed":
            return []
        out: List[str] = []
        enclosing = self._fidx.enclosing.get(id(call.func))
        for tgt in self._index.resolve_call(sf, call.func, enclosing):
            kp = self._index.seed_params(tgt)
            if not kp:
                continue
            tparams = tgt.params()
            for i in kp:
                arg = call.args[i] if i < len(call.args) else None
                for kw in call.keywords:
                    if i < len(tparams) and kw.arg == tparams[i]:
                        arg = kw.value
                if isinstance(arg, ast.Name) and arg.id not in out:
                    out.append(arg.id)
        return out

    def _calls_in_order(self, node):
        """Calls in (approximate) evaluation order within one statement,
        not descending into lambdas or nested function defs (their
        bodies run later, in their own scope with their own fresh
        parameters — analyzed separately)."""
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.Lambda, ast.FunctionDef,
                                ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, ast.Call):
                yield sub
            stack.extend(ast.iter_child_nodes(sub))

    @staticmethod
    def _stores(node):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx,
                                                        (ast.Store,
                                                         ast.Del)):
                yield sub.id

    def _scan_block(self, sf: SourceFile, stmts, consumed: Dict[str, int],
                    findings: List[Finding]) -> None:
        """Linear scan; ``consumed`` maps key name → line it was spent."""
        for st in stmts:
            # nested function definitions analyze independently (their
            # bodies run later, against their own keys)
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                self._scan_loop(sf, st, dict(consumed), findings)
                # conservatively clear names the loop stores
                for n in self._stores(st):
                    consumed.pop(n, None)
                continue
            if isinstance(st, (ast.If, ast.Try, ast.With, ast.AsyncWith)):
                header = getattr(st, "test", None) or \
                    getattr(st, "items", None)
                if header is not None:
                    items = header if isinstance(header, list) else [header]
                    for h in items:
                        h_node = getattr(h, "context_expr", h)
                        self._scan_exprs(sf, h_node, consumed, findings)
                for fieldname in _BLOCK_FIELDS:
                    sub = getattr(st, fieldname, None)
                    if sub:
                        self._scan_block(sf, sub, dict(consumed), findings)
                for h in getattr(st, "handlers", []):
                    self._scan_block(sf, h.body, dict(consumed), findings)
                # conservative: anything stored in any arm is fresh after
                for n in self._stores(st):
                    consumed.pop(n, None)
                continue
            # plain statement: consume keys in expression order, then
            # apply stores (``key, sub = split(key)`` consumes THEN
            # rebinds — correct and no finding)
            self._scan_exprs(sf, st, consumed, findings)
            for n in self._stores(st):
                consumed.pop(n, None)

    def _scan_exprs(self, sf, node, consumed, findings,
                    soft=frozenset()) -> None:
        """Expression scan, exclusive-path aware: the arms of an
        ``a if c else b`` (and the short-circuited tail of and/or
        chains) consume against a state COPY — only one arm runs, so a
        draw in each is NOT reuse.  ``soft`` holds names whose prior
        consumption happened OUTSIDE the current conditional position:
        a first in-arm use of such a name is "maybe reuse" (the arm may
        never run) and is not reported, but it re-arms the name so a
        SECOND in-arm use still is.  Consumption in BOTH arms of an
        IfExp merges back as definite.  Lambdas are their own scope."""
        if node is None or isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.IfExp):
            self._scan_exprs(sf, node.test, consumed, findings, soft)
            arms = []
            for arm in (node.body, node.orelse):
                state = dict(consumed)
                self._scan_exprs(sf, arm, state, findings,
                                 soft=set(consumed))
                arms.append(state)
            # consumed in BOTH arms = definitely consumed (one arm runs)
            for name in set(arms[0]) & set(arms[1]):
                consumed.setdefault(name, min(arms[0][name],
                                              arms[1][name]))
            return
        if isinstance(node, ast.BoolOp):
            self._scan_exprs(sf, node.values[0], consumed, findings, soft)
            for v in node.values[1:]:     # may be short-circuited away
                self._scan_exprs(sf, v, dict(consumed), findings,
                                 soft=set(consumed))
            return
        if isinstance(node, ast.Call):
            # args evaluate before the outer call consumes its key; the
            # soft set is SHARED down the whole arm (created mutable at
            # branch entry) so a first soft use re-arms for siblings too
            for sub in list(node.args) + [kw.value for kw in node.keywords]:
                self._scan_exprs(sf, sub, consumed, findings, soft)
            self._scan_exprs(sf, node.func, consumed, findings, soft)
            for name in self._key_names(sf, node):
                if name in consumed and name in soft:
                    soft.discard(name)    # re-armed: next in-arm use reports
                    consumed[name] = node.lineno
                elif name in consumed:
                    findings.append(Finding(
                        self.name, sf.path, node.lineno, node.col_offset,
                        f"seed `{name}` spent again (first on line "
                        f"{consumed[name]}) with no rebinding between — "
                        "both streams draw the same bits; derive each "
                        "from a distinct step_seed tuple"))
                else:
                    consumed[name] = node.lineno
            return
        for child in ast.iter_child_nodes(node):
            self._scan_exprs(sf, child, consumed, findings, soft)

    def _scan_loop(self, sf, loop, consumed, findings) -> None:
        """Flag keys consumed inside a loop body that the body never
        rebinds — every iteration replays the same draw."""
        body_stores = set()
        for st in loop.body + getattr(loop, "orelse", []):
            body_stores.update(self._stores(st))
        if isinstance(loop, (ast.For, ast.AsyncFor)):
            body_stores.update(self._stores(loop.target))

        for st in loop.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call in self._calls_in_order(st):
                for name in self._key_names(sf, call):
                    if name not in body_stores:
                        findings.append(Finding(
                            self.name, sf.path, call.lineno,
                            call.col_offset,
                            f"seed `{name}` spent inside a loop that "
                            "never rebinds it — every iteration draws the "
                            "same bits"))
        # and the body itself scans linearly for straight-line reuse
        self._scan_block(sf, loop.body, dict(consumed), findings)
