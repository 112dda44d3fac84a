"""Storage backends: disk / LMDB / in-memory (reference: data/file_client.py).

Counterpart of ``ssl_tpu/data/file_client.py``.  ``lmdb`` is imported only
when an lmdb backend is built; the memcached backend is not ported."""

from __future__ import annotations


class DiskBackend:
    def get(self, filepath: str, client_key: str | None = None) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class MemoryBackend:
    """Test helper: dict of path -> bytes."""

    def __init__(self, store: dict[str, bytes]):
        self.store = store

    def get(self, filepath: str, client_key: str | None = None) -> bytes:
        return self.store[str(filepath)]


class LmdbBackend:
    def __init__(self, db_paths, client_keys="default", readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("lmdb backend requires the 'lmdb' package") from e
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f"{len(client_keys)} client keys for {len(db_paths)} databases")
        self._clients = {}
        for key, path in zip(client_keys, db_paths):
            self._clients[key] = lmdb.open(str(path), readonly=True, lock=False,
                                           readahead=readahead, **kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        client = self._clients[client_key]
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the memcached io_backend is not ported yet "
                                  "(ROADMAP.md, queue 1)")


class FileClient:
    """Facade dispatching on io_backend type (reference file_client.py:85-167)."""

    _backends = {"disk": DiskBackend, "lmdb": LmdbBackend, "memory": MemoryBackend,
                 "memcached": MemcachedBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"Backend {backend} not supported. Supported: {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key="default"):
        return self.client.get(filepath, client_key)
