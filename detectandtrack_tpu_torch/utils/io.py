"""Pickle IO + file cache helpers (port of detectandtrack_tpu/utils/io.py;
parity: `lib/utils/io.py`).

The reference's `cache_url` downloads released weights; the port never
fetches anything, so URL inputs resolve only against the local cache
directory and raise otherwise.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any


def save_object(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_object(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def cache_url(url_or_path: str, cache_dir: str = "/tmp/dat_cache") -> str:
    """Resolve a URL to a local cached file. Offline: only cache hits work."""
    if not url_or_path.startswith(("http://", "https://")):
        return url_or_path
    digest = hashlib.sha256(url_or_path.encode()).hexdigest()[:16]
    fname = os.path.join(cache_dir, digest + "_" +
                         os.path.basename(url_or_path))
    if os.path.exists(fname):
        return fname
    raise FileNotFoundError(
        f"{url_or_path} not in cache ({fname}) and this environment has no "
        f"network egress; place the file there manually")
