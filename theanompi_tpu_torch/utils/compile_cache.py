"""Persistent cache of the compiled kernel libraries: build once, load
forever.

Counterpart of ``theanompi_tpu/utils/compile_cache.py``.  The JAX package
serializes its compiled XLA executables under a key it controls, so a
restarted process deserializes instead of recompiling.  The port has no
executable to serialize; it compiles two things:

* **the kernel libraries** (``ops/_kernel_build.py``): each
  ``csrc/<name>.cu`` built by ``nvcc`` into a shared library and opened
  with ``ctypes``.  These the cache keeps.
* **CUDA graphs** (``parallel/graph.py``): the captured steps.  A graph
  lives in one process and cannot be saved; its capture is timed and
  reported (``model.compile_info``), not cached.

**The key** (sha256 over a canonical JSON): the source's bytes, the
``nvcc`` flags (``_kernel_build.NVCC_FLAGS``, which fix ``sm_90a``) and
the toolkit's version as ``nvcc --version`` prints it.  A library built
by another toolkit is another key, never a stale hit.

**The fallback ladder** (:meth:`CompileCache.library`):

1. **hit**: the library is in the directory, its header
   (``<name>-<key>.json``) agrees with this toolkit, and ``ctypes``
   opens it;
2. **load fallback**: a library that does not open, or whose header is
   missing, damaged or names another toolkit, is rebuilt in place
   (counted in ``deserialize_fallbacks``);
3. **miss**: ``nvcc`` builds the library into the directory;
4. **cache off**: a directory that cannot be created or written disables
   the cache, and the library is built into ``build/kernels/`` as without
   one.

Every cache-side error ends in a build; a failed ``nvcc`` build still
raises (nothing falls back to a kernel's plain version).  A header or
manifest that cannot be written costs only persistence
(``serialize_unsupported``).

``manifest.json`` holds, per key: the library's name, the nvcc version,
the build seconds, the bytes, the hits and the last hit.  The JAX
manifest's ``program_summary`` (XLA's cost analysis of an executable) has
no counterpart: nvcc reports no cost model of a library.

:func:`resolve` is the one rule every entry point shares: the config key
``compile_cache`` (a path enables, ``False`` or ``""`` disables), else
``$THEANOMPI_COMPILE_CACHE``, else off; ``aot_cache=False`` disables it
whatever else is set.  ``python -m theanompi_tpu_torch.utils.compile_cache
DIR`` builds every library into ``DIR`` (prewarming).

Stdlib at module scope; the builds themselves are ``_kernel_build``'s.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

ENV_CACHE_DIR = "THEANOMPI_COMPILE_CACHE"

_FORMAT = 1
_MAGIC = "theanompi-kernel-lib"

# one shared instance per directory, so the counters aggregate across
# every load of the process
_INSTANCES: Dict[str, "CompileCache"] = {}


class _EntryMismatch(Exception):
    """Header/toolkit disagreement or damage: the load-fallback rung."""


def key_parts(source: bytes, flags: Iterable[str], toolkit: str) -> dict:
    """What a library's key hashes: its source's sha256, the flags and the
    toolkit that builds it (the manifest keeps them beside each entry)."""
    return {"source": hashlib.sha256(source).hexdigest(),
            "flags": list(flags), "nvcc": toolkit}


def library_key(source: bytes, flags: Iterable[str], toolkit: str) -> str:
    """Content-addressed key of one library: its source, the flags and the
    toolkit that builds it."""
    blob = json.dumps(key_parts(source, flags, toolkit), sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:40]


class CompileCache:
    """One cache directory: ``<name>-<key>.so`` libraries, each with its
    ``.json`` header, and ``manifest.json``.

    ``enabled=False`` builds the inert instance: :meth:`library` then
    builds into the default directory and reports ``cache: 'off'``.
    """

    def __init__(self, cache_dir: Optional[str], enabled: bool = True):
        self.cache_dir = cache_dir
        self.enabled = bool(enabled and cache_dir)
        self.counters = {"hits": 0, "misses": 0, "deserialize_fallbacks": 0,
                         "serialize_unsupported": 0}
        # the libraries load on a pool's threads (``_kernel_build.prewarm``):
        # the counters and the manifest's read-modify-write take this lock
        self._lock = threading.Lock()
        if self.enabled:
            try:
                os.makedirs(self.cache_dir, exist_ok=True)
                probe = os.path.join(self.cache_dir,
                                     f".probe.{os.getpid()}")
                with open(probe, "w"):
                    pass
                os.remove(probe)
            except OSError as e:
                # an uncreatable or read-only dir must degrade to the
                # default build directory, not fail the run
                print(f"compile_cache: cannot use {self.cache_dir} ({e}) "
                      f"— cache disabled", file=sys.stderr)
                self.enabled = False

    def _tick(self, kind: str) -> None:
        """Bump a ladder counter, mirrored into the process telemetry
        registry (``compile_cache.<kind>``)."""
        with self._lock:
            self.counters[kind] += 1
        from . import telemetry
        tm = telemetry.active()
        if tm.enabled:
            tm.counter("compile_cache." + kind)

    # -- entry IO ----------------------------------------------------------

    def path(self, name: str, key: str) -> str:
        return os.path.join(self.cache_dir, f"{name}-{key}.so")

    def _header_path(self, name: str, key: str) -> str:
        return self.path(name, key)[:-3] + ".json"

    def check_header(self, name: str, key: str, toolkit: str) -> dict:
        """The entry's header, checked against this toolkit.  Raises
        ``_EntryMismatch`` on damage or drift."""
        try:
            with open(self._header_path(name, key)) as f:
                header = json.load(f)
        except (OSError, ValueError) as e:
            raise _EntryMismatch(f"no readable header: {e}") from e
        if not isinstance(header, dict) or header.get("magic") != _MAGIC:
            raise _EntryMismatch("bad magic")
        if header.get("format") != _FORMAT:
            raise _EntryMismatch(f"entry format {header.get('format')!r}, "
                                 f"reader speaks {_FORMAT}")
        if header.get("nvcc") != toolkit:
            raise _EntryMismatch(f"built by nvcc {header.get('nvcc')!r}, "
                                 f"this toolkit is {toolkit!r}")
        return header

    def _write_header(self, name: str, key: str, toolkit: str) -> None:
        header = {"magic": _MAGIC, "format": _FORMAT, "name": name,
                  "nvcc": toolkit, "created": time.time()}
        tmp = self._header_path(name, key) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(header, f)
        os.replace(tmp, self._header_path(name, key))

    # -- the ladder --------------------------------------------------------

    def library(self, name: str, key: str, toolkit: str,
                build: Callable[[str], float], open_lib: Callable[[str], Any],
                default_path: str, parts: Optional[dict] = None):
        """Return ``(library, info)`` for one kernel library.

        ``build(path)`` compiles it to ``path`` and returns the seconds it
        took (raising when the compiler fails); ``open_lib(path)`` loads it.
        ``parts`` (:func:`key_parts`) goes into the manifest beside a new
        entry, so that ``tools/explain_program --diff`` can name the part
        that split two keys.
        ``info``: ``cache`` ∈ {hit, miss, deserialize_fallback, off},
        ``compile_secs`` (the whole rung: the build for a miss, the open
        for a hit), ``key``, ``path``, ``serialized``."""
        t0 = time.time()
        if not self.enabled:
            secs = None
            if not os.path.exists(default_path):
                secs = build(default_path)
            lib = open_lib(default_path)
            return lib, {"cache": "off", "key": key, "path": default_path,
                         "compile_secs": round(time.time() - t0, 3),
                         "build_secs": secs, "serialized": False}
        path = self.path(name, key)
        info: Dict[str, Any] = {"cache": "miss", "key": key, "path": path,
                                "serialized": False, "build_secs": None}
        if os.path.exists(path):
            try:
                self.check_header(name, key, toolkit)
                lib = open_lib(path)
            except Exception as e:
                # damaged library or header, another toolkit: rung 2
                self._tick("deserialize_fallbacks")
                info["cache"] = "deserialize_fallback"
                info["fallback_reason"] = str(e)[:300]
                print(f"compile_cache: {name} entry {key[:12]} unusable "
                      f"({str(e)[:200]}) — rebuilding", file=sys.stderr)
            else:
                self._tick("hits")
                self._bump_manifest(key)
                info.update(cache="hit",
                            compile_secs=round(time.time() - t0, 3))
                return lib, info
        if info["cache"] == "miss":
            self._tick("misses")
        secs = build(path)                   # a failed build raises
        info["build_secs"] = round(secs, 3)
        try:
            self._write_header(name, key, toolkit)
            self._record_manifest(key, name, toolkit, secs,
                                  os.path.getsize(path), parts)
            info["serialized"] = True
        except OSError as e:
            # the library is built and usable; only persistence is lost
            self._tick("serialize_unsupported")
            info["serialize_error"] = str(e)[:300]
        lib = open_lib(path)
        info["compile_secs"] = round(time.time() - t0, 3)
        return lib, info

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.cache_dir, "manifest.json")

    def load_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            return m if isinstance(m, dict) else {}
        except (OSError, ValueError):
            return {}

    def _save_manifest(self, m: dict) -> None:
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(m, f, indent=1, sort_keys=True)
            os.replace(tmp, self._manifest_path())
        except OSError:
            pass                              # metadata only — never fatal

    def _record_manifest(self, key, name, toolkit, build_secs, nbytes,
                         parts: Optional[dict] = None):
        """One entry: its library's name, the toolkit, the key's other parts
        (the source's sha256 and the flags, when given), the build's
        seconds and bytes."""
        with self._lock:
            m = self.load_manifest()
            m[key] = {"name": name, "nvcc": toolkit,
                      "build_secs": round(build_secs, 2),
                      "bytes": int(nbytes), "created": time.time(),
                      "hits": 0, "last_hit": None}
            if parts:
                m[key].update(source=parts.get("source"),
                              flags=list(parts.get("flags", ())))
            self._save_manifest(m)

    def _bump_manifest(self, key):
        with self._lock:
            m = self.load_manifest()
            if key in m:
                m[key]["hits"] = int(m[key].get("hits", 0)) + 1
                m[key]["last_hit"] = time.time()
                self._save_manifest(m)

    # -- reporting ---------------------------------------------------------

    def describe(self) -> str:
        c = self.counters
        return (f"{c['hits']} hit / {c['misses']} miss / "
                f"{c['deserialize_fallbacks']} load-fallback / "
                f"{c['serialize_unsupported']} unserializable "
                f"(dir={self.cache_dir})")


_DISABLED = CompileCache(None, enabled=False)


def get(cache_dir: Optional[str]) -> CompileCache:
    """Shared per-directory instance (process-wide counters)."""
    if not cache_dir:
        return _DISABLED
    cache_dir = os.path.abspath(cache_dir)
    inst = _INSTANCES.get(cache_dir)
    if inst is None:
        inst = _INSTANCES[cache_dir] = CompileCache(cache_dir)
    return inst


def resolve(config: Optional[dict] = None) -> CompileCache:
    """The one resolution rule every entry point shares: the config key
    ``compile_cache`` (a path enables, ``False``/``""`` force-disables),
    else the ``THEANOMPI_COMPILE_CACHE`` env var, else off.
    ``aot_cache=False`` in the config force-disables regardless."""
    config = config or {}
    if config.get("aot_cache", True) is False:
        return _DISABLED
    if "compile_cache" in config:
        d = config["compile_cache"]
        return get(str(d)) if d else _DISABLED
    return get(os.environ.get(ENV_CACHE_DIR) or None)


def main(argv=None) -> int:
    """``python -m theanompi_tpu_torch.utils.compile_cache DIR [name ...]``:
    build every kernel library (or the named ones) into ``DIR``, one
    ``nvcc`` each, all started together; prints each one's rung."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0].startswith("-"):
        print("usage: python -m theanompi_tpu_torch.utils.compile_cache "
              "DIR [name ...]", file=sys.stderr)
        return 1
    cache = get(argv[0])
    if not cache.enabled:
        return 1
    from ..ops import _kernel_build
    infos = _kernel_build.prewarm(cache, argv[1:] or None)
    for name, info in sorted(infos.items()):
        print(f"{name}: {info['cache']} ({info['compile_secs']:.1f}s) "
              f"{info['path']}", flush=True)
    print(f"compile cache [{cache.describe()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
