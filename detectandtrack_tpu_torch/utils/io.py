"""Pickle IO (port of detectandtrack_tpu/utils/io.py; parity:
`lib/utils/io.py`). The original's `cache_url` is not copied: nothing in
the port fetches weights by URL."""

from __future__ import annotations

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
