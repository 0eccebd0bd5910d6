"""Record shards for the RefCOCO-family path (counterpart of
crog_tpu/data/shards.py).

A record is a dict of numpy arrays, scalars, strings and bytes, stored as
``np.savez_compressed`` bytes (scalars under ``scalar::<key>``, bytes under
``bytes::<key>``).  A directory shard holds one ``<key>.npz`` per record
and ``__index__.json`` ({"keys": [...], "backend": "dir"}); an LMDB shard
holds the records under their keys and the key list under ``__keys__``.
Both are the JAX package's format byte for byte, so shards written by
``tools/folder2lmdb.py`` read here and the reverse.  ``lmdb`` is imported
only when an LMDB shard is written or opened.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Iterator, List

import numpy as np

INDEX = "__index__.json"


def encode_record(record: Dict) -> bytes:
    """A dict of numpy arrays / scalars / strings / bytes as npz bytes."""
    norm = {}
    for k, v in record.items():
        if isinstance(v, (str, int, float, bool)):
            norm[f"scalar::{k}"] = np.asarray(v)
        elif isinstance(v, bytes):
            norm[f"bytes::{k}"] = np.frombuffer(v, np.uint8)
        else:
            norm[k] = np.asarray(v)
    buf = io.BytesIO()
    np.savez_compressed(buf, **norm)
    return buf.getvalue()


def decode_record(data: bytes) -> Dict:
    z = np.load(io.BytesIO(data), allow_pickle=False)
    out: Dict = {}
    for k in z.files:
        if k.startswith("scalar::"):
            out[k[8:]] = z[k].item()
        elif k.startswith("bytes::"):
            out[k[7:]] = z[k].tobytes()
        else:
            out[k] = z[k]
    return out


def _lmdb():
    try:
        import lmdb  # type: ignore
    except ImportError as exc:
        raise RuntimeError("an LMDB shard needs the lmdb package, which is not "
                           "installed; use a directory shard") from exc
    return lmdb


class ShardWriter:
    """Writes records under string keys; ``close`` writes the key index."""

    def __init__(self, path: str, backend: str = "dir"):
        if backend not in ("dir", "lmdb"):
            raise ValueError(f"unknown shard backend {backend!r}")
        self.path = path
        self.backend = backend
        self.keys: List[str] = []
        if backend == "lmdb":
            self._env = _lmdb().open(path, map_size=1 << 40)
            self._txn = self._env.begin(write=True)
        else:
            os.makedirs(path, exist_ok=True)

    def put(self, key: str, record: Dict):
        data = encode_record(record)
        if self.backend == "lmdb":
            self._txn.put(key.encode(), data)
            if len(self.keys) % 500 == 499:
                self._txn.commit()
                self._txn = self._env.begin(write=True)
        else:
            with open(os.path.join(self.path, f"{key}.npz"), "wb") as f:
                f.write(data)
        self.keys.append(key)

    def close(self):
        if self.backend == "lmdb":
            self._txn.put(b"__keys__", json.dumps(self.keys).encode())
            self._txn.commit()
            self._env.sync()
            self._env.close()
        else:
            with open(os.path.join(self.path, INDEX), "w") as f:
                json.dump({"keys": self.keys, "backend": "dir"}, f)


class ShardReader:
    """Reads a directory shard (it has ``__index__.json``), else an LMDB
    one; ``reader[i]`` is the i-th record in write order."""

    def __init__(self, path: str):
        self.path = path
        index = os.path.join(path, INDEX)
        if os.path.isfile(index):
            self.backend = "dir"
            with open(index) as f:
                self.keys = json.load(f)["keys"]
        else:
            self.backend = "lmdb"
            self._env = _lmdb().open(path, readonly=True, lock=False, readahead=False,
                                     meminit=False)
            with self._env.begin(write=False) as txn:
                self.keys = json.loads(txn.get(b"__keys__").decode())

    def __len__(self):
        return len(self.keys)

    def get(self, key: str) -> Dict:
        if self.backend == "lmdb":
            with self._env.begin(write=False) as txn:
                return decode_record(txn.get(key.encode()))
        with open(os.path.join(self.path, f"{key}.npz"), "rb") as f:
            return decode_record(f.read())

    def __getitem__(self, i: int) -> Dict:
        return self.get(self.keys[i])

    def __iter__(self) -> Iterator[Dict]:
        for k in self.keys:
            yield self.get(k)
