"""Print and diff the kernel-library cache's manifest: ``python -m
theanompi_tpu_torch.tools.explain_program``.

The port's compile cache (``utils/compile_cache.CompileCache``) keeps one
nvcc-built library per key, the key the sha256 of its parts: the
source's sha256, the nvcc flags and the toolkit's version
(``compile_cache.key_parts``).  Its ``manifest.json`` records each
entry's library name, toolkit, parts, build seconds, size and hits; this
tool reads it (and nothing else: no library is opened).

    python -m theanompi_tpu_torch.tools.explain_program <cache_dir>
    python -m theanompi_tpu_torch.tools.explain_program <cache_dir> --json
    python -m theanompi_tpu_torch.tools.explain_program <cache_dir> --diff A B

``A``/``B`` resolve by key prefix first, then by library name (the
newest entry of that name wins).  The diff names the key part that split
two keys — ``source``, ``flags`` (the flags added and dropped) or
``toolkit`` — and says ``unknown`` for an entry written before the
manifest kept the parts.

Exit codes, as the JAX package's tool's: 0 done, 1 an empty manifest,
2 no manifest or an entry that does not resolve.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: the key's parts: manifest field -> what the diff calls it
KEY_PARTS = (("source", "source"), ("flags", "flags"), ("nvcc", "toolkit"))


def load_manifest(cache_dir: str) -> Optional[dict]:
    path = os.path.join(cache_dir, "manifest.json")
    try:
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
    except OSError:
        print(f"no manifest at {path}: not a compile-cache directory (or "
              f"nothing cached yet)", file=sys.stderr)
        return None
    except ValueError as e:
        print(f"unparseable manifest {path}: {e}", file=sys.stderr)
        return None
    return m if isinstance(m, dict) else {}


def resolve(manifest: dict, token: str):
    """One entry by key prefix, else by library name (newest wins)."""
    hits = [(k, v) for k, v in manifest.items() if k.startswith(token)]
    if not hits:
        hits = [(k, v) for k, v in manifest.items()
                if str(v.get("name", "")) == token]
    if not hits:
        return None, None
    return max(hits, key=lambda kv: kv[1].get("created") or 0)


def _age(created) -> str:
    if not created:
        return "-"
    secs = max(0.0, time.time() - float(created))
    for unit, div in (("d", 86400), ("h", 3600), ("m", 60)):
        if secs >= div:
            return f"{secs / div:.1f}{unit}"
    return f"{secs:.0f}s"


def _bytes(v) -> str:
    if v is None:
        return "-"
    for unit, div in (("MiB", 2 ** 20), ("KiB", 2 ** 10)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v}B"


def print_table(manifest: dict) -> None:
    rows = sorted(manifest.items(),
                  key=lambda kv: kv[1].get("created") or 0, reverse=True)
    print(f"{'key':<14}{'library':<20}{'source':<14}{'build':>8}"
          f"{'size':>11}{'hits':>6}{'age':>8}  toolkit")
    for key, e in rows:
        src = str(e.get("source") or "unknown")[:12]
        secs = e.get("build_secs")
        print(f"{key[:12]:<14}{str(e.get('name', '?'))[:18]:<20}{src:<14}"
              f"{('-' if secs is None else f'{secs:.1f}s'):>8}"
              f"{_bytes(e.get('bytes')):>11}{e.get('hits', 0):>6}"
              f"{_age(e.get('created')):>8}  {e.get('nvcc', '?')}")
    old = sum(1 for _, e in rows if "source" not in e)
    if old:
        print(f"({old} entr{'y predates' if old == 1 else 'ies predate'} "
              f"the key parts in the manifest: source and flags unknown)",
              file=sys.stderr)


def split_parts(a: dict, b: dict) -> List[str]:
    """The key parts in which two entries differ (``unknown`` when either
    lacks them)."""
    if any("source" not in e or "flags" not in e for e in (a, b)):
        return ["unknown"]
    return [label for field, label in KEY_PARTS
            if a.get(field) != b.get(field)]


def print_diff(manifest: dict, a_tok: str, b_tok: str) -> int:
    ak, a = resolve(manifest, a_tok)
    bk, b = resolve(manifest, b_tok)
    missing = [t for t, k in ((a_tok, ak), (b_tok, bk)) if k is None]
    if missing:
        print(f"cannot resolve {missing} against the manifest (a key prefix "
              f"or a library name)", file=sys.stderr)
        return 2
    for tag, k, e in (("A", ak, a), ("B", bk, b)):
        print(f"{tag}: {k[:12]} {e.get('name')} (built "
              f"{_age(e.get('created'))} ago, {e.get('build_secs')}s, "
              f"{_bytes(e.get('bytes'))}, {e.get('hits', 0)} hits)")
    parts = split_parts(a, b)
    if parts == ["unknown"]:
        print("key split: unknown (an entry predates the key parts in the "
              "manifest; rebuild it to record them)")
        return 0
    if not parts:
        print("key split: none — the same source, flags and toolkit "
              f"({'the same entry' if ak == bk else 'two keys of one input'})")
        return 0
    print(f"key split: {', '.join(parts)}")
    if "source" in parts:
        print(f"  source   {str(a.get('source'))[:16]} -> "
              f"{str(b.get('source'))[:16]}")
    if "flags" in parts:
        fa, fb = list(a.get("flags") or ()), list(b.get("flags") or ())
        added = [f for f in fb if f not in fa]
        dropped = [f for f in fa if f not in fb]
        print(f"  flags    +{added} -{dropped}" if added or dropped else
              f"  flags    reordered: {fa} -> {fb}")
    if "toolkit" in parts:
        print(f"  toolkit  {a.get('nvcc')} -> {b.get('nvcc')}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.tools.explain_program",
        description="print and diff the kernel-library cache's manifest")
    ap.add_argument("cache_dir")
    ap.add_argument("--json", action="store_true",
                    help="the raw manifest dict")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="two entries (key prefix or library name)")
    args = ap.parse_args(argv)
    manifest = load_manifest(args.cache_dir)
    if manifest is None:
        return 2
    if not manifest:
        print("manifest is empty: nothing cached yet", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(manifest, indent=1, sort_keys=True))
        return 0
    if args.diff:
        return print_diff(manifest, *args.diff)
    print_table(manifest)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        os._exit(0)
