"""The columnar (parquet) data path of the estimators — the port's copy
of ``horovod_tpu/parquet.py`` (Horovod's Petastorm stores: each
training worker reads only its shard, ``cur_shard=rank,
shard_count=size``).

:func:`write_parquet_shards` writes aligned numpy columns as pyarrow
parquet shard files through a :class:`~horovod_tpu_torch.store.Store`
(local disk or any fsspec URL); an N-d column rides a flattened
``list<item>`` column with its row shape in the file's schema metadata.
:class:`ParquetDataset` reads the files ``files[rank::size]`` of a
rank. A ``_manifest.json`` written last names exactly one write's
files, so a reused directory never leaks an older write's parts. The
files are the JAX package's format: either package reads the other's.
pyarrow is imported at use, so the package imports without it.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional

import numpy as np

from .store import Store

_META_KEY = b"horovod_tpu.shapes"
_MANIFEST = "_manifest.json"


def write_parquet_shards(store: Store, dir_path: str,
                         columns: Dict[str, np.ndarray],
                         num_shards: int = 4) -> List[str]:
    """Split aligned column arrays row-wise into ``num_shards`` parquet
    files under ``dir_path`` and return their paths; the manifest
    (written last) lists exactly these files and each column's dtype and
    row shape."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    lengths = {k: len(v) for k, v in columns.items()}
    if len(set(lengths.values())) != 1:
        raise ValueError(f"column lengths differ: {lengths}")
    nrows = next(iter(lengths.values()))
    num_shards = max(1, min(num_shards, nrows))
    shapes = {k: list(np.asarray(v).shape[1:]) for k, v in columns.items()}
    meta = {_META_KEY: json.dumps(shapes).encode()}

    paths: List[str] = []
    bounds = np.linspace(0, nrows, num_shards + 1, dtype=int)
    for shard in range(num_shards):
        lo, hi = int(bounds[shard]), int(bounds[shard + 1])
        arrays, names = [], []
        for name, col in columns.items():
            part = np.asarray(col)[lo:hi]
            if part.ndim > 1:
                arrays.append(pa.array(list(part.reshape(len(part), -1))))
            else:
                arrays.append(pa.array(part))
            names.append(name)
        table = pa.Table.from_arrays(arrays, names=names)
        table = table.replace_schema_metadata(
            {**(table.schema.metadata or {}), **meta})
        path = store.path_join(dir_path, f"part-{shard:05d}.parquet")
        with store.open(path, "wb") as f:
            pq.write_table(table, f)
        paths.append(path)
    store.write(store.path_join(dir_path, _MANIFEST), json.dumps({
        "files": [f"part-{s:05d}.parquet" for s in range(num_shards)],
        "num_rows": nrows,
        "columns": {k: {"dtype": str(np.asarray(v).dtype),
                        "shape": shapes[k]}
                    for k, v in columns.items()},
    }).encode())
    return paths


class ParquetDataset:
    """The shard of one rank of a parquet shard directory: the files
    ``files[rank::size]`` (disjoint across ranks, their union the whole
    dataset). Iterate for batches (dicts of numpy arrays) or call
    :meth:`load` for the whole shard."""

    def __init__(self, store: Store, dir_path: str, batch_size: int = 32,
                 rank: int = 0, size: int = 1,
                 shuffle_seed: Optional[int] = None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside world of {size}")
        self.store = store
        self.batch_size = batch_size
        self.shuffle_seed = shuffle_seed
        self._columns_meta: Dict[str, dict] = {}
        #: The dataset's row count from the manifest (None for a
        #: directory without one): every rank agrees on it without
        #: reading the other ranks' files.
        self.total_rows: Optional[int] = None
        manifest_path = store.path_join(dir_path, _MANIFEST)
        if store.exists(manifest_path):
            manifest = json.loads(store.read(manifest_path))
            all_files = manifest["files"]
            self._columns_meta = manifest.get("columns", {})
            self.total_rows = manifest.get("num_rows")
        else:
            all_files = sorted(n for n in store.listdir(dir_path)
                               if n.endswith(".parquet"))
        if not all_files:
            raise FileNotFoundError(
                f"no .parquet shards under {dir_path}")
        self.files = [store.path_join(dir_path, n)
                      for n in all_files[rank::size]]

    def _read_file(self, path: str) -> Dict[str, np.ndarray]:
        import pyarrow as pa
        import pyarrow.parquet as pq

        with self.store.open(path, "rb") as f:
            table = pq.read_table(f)
        shapes = json.loads(
            (table.schema.metadata or {}).get(_META_KEY, b"{}"))
        out = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            # to_numpy keeps the arrow value type (float32 stays float32).
            if pa.types.is_list(col.type):
                arr = col.flatten().to_numpy(zero_copy_only=False) \
                    .reshape(len(col), -1)
            else:
                arr = col.to_numpy(zero_copy_only=False)
            shape = shapes.get(name, [])
            if shape:
                arr = arr.reshape((len(arr),) + tuple(shape))
            out[name] = arr
        return out

    def load(self) -> Dict[str, np.ndarray]:
        """This rank's whole shard, concatenated. A rank that drew no
        file gets 0-row arrays of each column's dtype and row shape
        when the manifest carries them."""
        if not self.files:
            if not self._columns_meta:
                raise FileNotFoundError(
                    "this rank drew no shard files and the directory "
                    "has no manifest to synthesize an empty shard from")
            return {k: np.empty((0,) + tuple(m["shape"]),
                                dtype=np.dtype(m["dtype"]))
                    for k, m in self._columns_meta.items()}
        parts = [self._read_file(p) for p in self.files]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.files)))
        if self.shuffle_seed is not None:
            np.random.default_rng(self.shuffle_seed).shuffle(order)
        for i in order:
            data = self._read_file(self.files[i])
            n = len(next(iter(data.values())))
            row_order = np.arange(n)
            if self.shuffle_seed is not None:
                np.random.default_rng(
                    self.shuffle_seed + i).shuffle(row_order)
            for lo in range(0, n, self.batch_size):
                idx = row_order[lo:lo + self.batch_size]
                yield {k: v[idx] for k, v in data.items()}

    def num_rows(self) -> int:
        import pyarrow.parquet as pq

        total = 0
        for p in self.files:
            with self.store.open(p, "rb") as f:
                total += pq.ParquetFile(f).metadata.num_rows
        return total
