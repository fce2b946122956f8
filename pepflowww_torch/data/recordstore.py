"""Single-file keyed record store: the preprocessing cache (counterpart of
the JAX package's ``data/recordstore.py``, the same bytes on disk).

``<path>`` holds concatenated zlib-compressed (level 1) pickle blobs
(protocol 4); ``<path>.idx`` is a JSON index {key: [offset, length]}
written on close. Readers mmap the data file and decompress entries on
demand, so a cache written by either package reads in the other.
"""

from __future__ import annotations

import json
import mmap
import os
import pickle
import zlib
from typing import Iterator


class RecordStoreWriter:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._index: dict = {}

    def put(self, key: str, obj) -> None:
        blob = zlib.compress(pickle.dumps(obj, protocol=4), level=1)
        offset = self._f.tell()
        self._f.write(blob)
        self._index[key] = [offset, len(blob)]

    def close(self) -> None:
        self._f.close()
        with open(self.path + ".idx", "w") as f:
            json.dump(self._index, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordStore:
    """Read-only view; cheap to open in each process."""

    def __init__(self, path: str):
        self.path = path
        with open(path + ".idx") as f:
            self._index = json.load(f)
        self._keys = list(self._index.keys())
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    @property
    def keys(self) -> list:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def get(self, key: str):
        offset, length = self._index[key]
        return pickle.loads(zlib.decompress(self._mm[offset:offset + length]))

    def __getitem__(self, i: int):
        return self.get(self._keys[i])

    def __iter__(self) -> Iterator:
        for k in self._keys:
            yield self.get(k)

    def close(self) -> None:
        self._mm.close()
        self._f.close()


def exists(path: str) -> bool:
    return os.path.exists(path) and os.path.exists(path + ".idx")
