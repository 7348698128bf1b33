"""Opt-in disk cache for host-built env statics (fast warm starts).

Building `EnvStatics` (incl. the painter tables) is host-side Python
(slot layout, beam walks, window classes — ~5 s for the 400x400/960
production shape).  The tables are a pure function of (config, map file,
package source), so serving fleets can reuse them across processes:

    export IMG_ENV_TPU_STATICS_CACHE=~/.cache/img_env_tpu

The key hashes the full config repr, the map file bytes, and a fingerprint
of every .py file in the package — ANY source or map edit invalidates the
entry, so a stale cache can never leak into a parity result.  Entries are
pickles written atomically; corruption or version drift falls back to a
fresh build.  (The reference has no analogue: its tables are rebuilt by
every ROS node at launch, img_env.cpp:169-193.)
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Optional

_FPRINT = None


def cache_dir() -> Optional[str]:
    d = os.environ.get("IMG_ENV_TPU_STATICS_CACHE", "")
    return os.path.expanduser(d) if d else None


def _package_fingerprint() -> str:
    """Hash of (relpath, size, mtime_ns) for every package .py file."""
    global _FPRINT
    if _FPRINT is not None:
        return _FPRINT
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            st = os.stat(p)
            h.update(os.path.relpath(p, root).encode())
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    _FPRINT = h.hexdigest()
    return _FPRINT


def cache_key(cfg, map_path: Optional[str]) -> str:
    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    h.update(_package_fingerprint().encode())
    if map_path and os.path.exists(map_path):
        with open(map_path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:32]


def load(key: str) -> Optional[Any]:
    d = cache_dir()
    if not d:
        return None
    path = os.path.join(d, f"statics-{key}.pkl")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        return None


def save(key: str, obj: Any) -> None:
    d = cache_dir()
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(d, f"statics-{key}.pkl"))
    except Exception:
        pass  # cache is best-effort; never fail a build over it
