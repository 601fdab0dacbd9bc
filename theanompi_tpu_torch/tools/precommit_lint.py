"""The lint as a pre-commit hook: ``python -m
theanompi_tpu_torch.tools.precommit_lint``.

    printf '#!/bin/sh\nexec python -m theanompi_tpu_torch.tools.precommit_lint\n' \\
        > .git/hooks/pre-commit && chmod +x .git/hooks/pre-commit

It lints exactly the STAGED content of the staged ``.py`` files: their
blobs are checked out of the index into a temporary tree
(``git checkout-index``) and linted there (``--root``), so the verdict
matches what the commit will hold even when the worktree has further
unstaged edits.  The repository's baseline (``tpulint_torch_baseline.json``)
and result cache (``.tpulint_torch_cache/``) are passed through, so a
re-commit of unchanged staged content is a cache hit.  Which files count
is the lint's own ``--diff CACHED`` (the staged ``.py`` files against
HEAD, within the lint's paths): this hook checks out every staged ``.py``
blob and does not filter them a second time.

``TPULINT_SARIF=<path>`` also writes a SARIF 2.1.0 log of the new
findings to ``<path>``; it shares the result cache, so it costs one hit.

Exit codes, as the lint's: 0 clean, 1 findings, 2 a bad invocation (or
git failing).
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional

from ..analysis import cli
from ..analysis.cache import CACHE_DIR_NAME
from ..analysis.core import BASELINE_NAME


def _git(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(["git", *args], capture_output=True, text=True,
                          timeout=120)


def main(argv: Optional[List[str]] = None) -> int:
    top = _git("rev-parse", "--show-toplevel")
    if top.returncode != 0:
        print(f"precommit-lint: not in a git checkout "
              f"({top.stderr.strip()})", file=sys.stderr)
        return 2
    repo = top.stdout.strip()
    staged = _git("-C", repo, "diff", "--cached", "--name-only",
                  "--diff-filter=d", "--", "*.py")
    if staged.returncode != 0:
        print(f"precommit-lint: {staged.stderr.strip()}", file=sys.stderr)
        return 2
    files = [f for f in staged.stdout.splitlines() if f.strip()]
    if not files:
        print("precommit-lint: no staged python files")
        return 0
    tmp = tempfile.mkdtemp(prefix="tpulint-precommit.")
    try:
        out = _git("-C", repo, "checkout-index", f"--prefix={tmp}/", "--",
                   *files)
        if out.returncode != 0:
            print(f"precommit-lint: {out.stderr.strip()}", file=sys.stderr)
            return 2
        common = ["--root", tmp,
                  "--baseline", os.path.join(repo, BASELINE_NAME),
                  "--cache-dir", os.path.join(repo, CACHE_DIR_NAME),
                  "--diff", "CACHED"]
        cwd = os.getcwd()
        os.chdir(repo)              # --diff asks git here: the temp tree
        try:                        # is no checkout
            rc = cli.main(common + list(argv or []))
            sarif = os.environ.get("TPULINT_SARIF")
            if sarif:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    src = cli.main(common + ["--format", "sarif"])
                if src in (0, 1):
                    with open(sarif, "w", encoding="utf-8") as f:
                        f.write(buf.getvalue())
                else:
                    print("precommit-lint: SARIF emit failed (the verdict "
                          "above stands)", file=sys.stderr)
        finally:
            os.chdir(cwd)
        return rc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
