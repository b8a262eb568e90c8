"""Store: persistent artifact storage for training runs, the port's copy
of ``horovod_tpu/store.py``.

Horovod's Spark estimators keep a ``Store`` (``LocalStore``/
``HDFSStore``): per-run checkpoint and log directories, data paths and
read/write/exists primitives, with ``Store.create`` dispatching on the
prefix's scheme. Here: a small filesystem protocol with a local store,
an fsspec store for any URL scheme (``hdfs://``, ``s3://``,
``memory://``, ...; fsspec is imported at use) and a GCS store gated on
gcsfs. Objects cross as pickle blobs; ``checkpoint.CheckpointManager``
writes into ``get_checkpoint_path(run_id)`` directly.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Iterator


class Store:
    """Abstract per-run artifact store (reference store.py Store)."""

    @classmethod
    def create(cls, prefix_path: str, **kwargs) -> "Store":
        """Scheme dispatch (reference Store.create: HDFS vs local —
        store.py:60-78). Any URL scheme (hdfs://, s3://, memory://, ...)
        routes to the fsspec-backed store; gs:// prefers the dedicated
        GCS store when gcsfs is present."""
        if prefix_path.startswith("gs://"):
            # No fsspec fallback: resolving gs:// through fsspec needs
            # the same gcsfs package, so the curated error is strictly
            # more actionable.
            return GCSStore(prefix_path, **kwargs)
        if "://" in prefix_path:
            return FsspecStore(prefix_path, **kwargs)
        return LocalStore(prefix_path, **kwargs)

    # -- filesystem primitives --------------------------------------------

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def listdir(self, path: str) -> Iterator[str]:
        raise NotImplementedError

    def path_join(self, *parts: str) -> str:
        raise NotImplementedError

    def open(self, path: str, mode: str = "rb"):
        """Streaming file handle — the primitive the columnar (parquet)
        data path reads/writes through."""
        raise NotImplementedError

    # -- object layer ------------------------------------------------------

    def write_obj(self, path: str, obj: Any) -> None:
        self.write(path, pickle.dumps(obj))

    def read_obj(self, path: str) -> Any:
        return pickle.loads(self.read(path))

    # -- run layout (reference: get_checkpoint_path/get_logs_path/
    #    get_train_data_path, store.py) -----------------------------------

    def prefix(self) -> str:
        raise NotImplementedError

    def get_run_path(self, run_id: str) -> str:
        return self.path_join(self.prefix(), "runs", run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return self.path_join(self.get_run_path(run_id), "checkpoints")

    def get_logs_path(self, run_id: str) -> str:
        return self.path_join(self.get_run_path(run_id), "logs")

    def get_data_path(self, run_id: str, name: str = "train") -> str:
        return self.path_join(self.get_run_path(run_id),
                              f"{name}_data.pkl")


class LocalStore(Store):
    """Filesystem store rooted at ``prefix_path`` (reference LocalStore)."""

    def __init__(self, prefix_path: str):
        self._prefix = os.path.abspath(prefix_path)
        os.makedirs(self._prefix, exist_ok=True)

    def prefix(self) -> str:
        return self._prefix

    def path_join(self, *parts: str) -> str:
        return os.path.join(*parts)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str):
        return iter(sorted(os.listdir(path)) if os.path.isdir(path)
                    else [])

    def open(self, path: str, mode: str = "rb"):
        if "w" in mode:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, mode)


class FsspecStore(Store):
    """URL-addressed store over any fsspec filesystem — the HDFSStore
    analog (reference store.py HDFSStore:1-504 rides pyarrow's HDFS
    client; fsspec is the ecosystem's superset: hdfs://, s3://, gcs://,
    memory://, ...). The filesystem is resolved once from the prefix
    scheme; paths keep their fully-qualified URL form so run layouts
    copy-paste between backends."""

    def __init__(self, prefix_path: str, **storage_options):
        import fsspec

        self._fs, _ = fsspec.core.url_to_fs(prefix_path,
                                            **storage_options)
        self._prefix = prefix_path.rstrip("/")
        self._fs.makedirs(self._strip(self._prefix), exist_ok=True)

    def _strip(self, path: str) -> str:
        return self._fs._strip_protocol(path)

    def prefix(self) -> str:
        return self._prefix

    def path_join(self, *parts: str) -> str:
        return "/".join(p.strip("/") if i else p.rstrip("/")
                        for i, p in enumerate(parts))

    def exists(self, path: str) -> bool:
        return self._fs.exists(self._strip(path))

    def read(self, path: str) -> bytes:
        with self._fs.open(self._strip(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        p = self._strip(path)
        parent = p.rsplit("/", 1)[0]
        if parent:
            self._fs.makedirs(parent, exist_ok=True)
        with self._fs.open(p, "wb") as f:
            f.write(data)

    def mkdirs(self, path: str) -> None:
        self._fs.makedirs(self._strip(path), exist_ok=True)

    def listdir(self, path: str):
        p = self._strip(path)
        if not self._fs.exists(p):
            return iter([])
        return iter(sorted(
            name.rsplit("/", 1)[-1]
            for name in self._fs.ls(p, detail=False)))

    def open(self, path: str, mode: str = "rb"):
        p = self._strip(path)
        if "w" in mode:
            parent = p.rsplit("/", 1)[0]
            if parent:
                self._fs.makedirs(parent, exist_ok=True)
        return self._fs.open(p, mode)


class GCSStore(Store):
    """GCS store (the HDFSStore analog). Gated on gcsfs being installed:
    without it, construction raises with a clear message rather than
    half-working."""

    def __init__(self, prefix_path: str, **kwargs):
        try:
            import gcsfs  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "GCSStore requires gcsfs; pip install gcsfs or use a "
                "LocalStore prefix (reference parity: HDFSStore likewise "
                "requires pyarrow/hdfs)") from e
        import gcsfs

        self._fs = gcsfs.GCSFileSystem(**kwargs)
        self._prefix = prefix_path.rstrip("/")

    def prefix(self) -> str:
        return self._prefix

    def path_join(self, *parts: str) -> str:
        return "/".join(p.strip("/") if i else p.rstrip("/")
                        for i, p in enumerate(parts))

    def exists(self, path: str) -> bool:  # pragma: no cover - needs GCS
        return self._fs.exists(path)

    def read(self, path: str) -> bytes:  # pragma: no cover - needs GCS
        with self._fs.open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:  # pragma: no cover
        with self._fs.open(path, "wb") as f:
            f.write(data)

    def mkdirs(self, path: str) -> None:  # pragma: no cover - needs GCS
        pass  # GCS has no directories

    def listdir(self, path: str):  # pragma: no cover - needs GCS
        return iter(self._fs.ls(path))

    def open(self, path: str, mode: str = "rb"):  # pragma: no cover
        return self._fs.open(path, mode)
