"""The port's mempool package (``p1_tpu/mempool/__init__.py``'s exports)."""

from p1_tpu_torch.mempool.mempool import (
    Mempool,
    dump_mempool,
    load_mempool,
    save_mempool,
    sync_key,
    write_mempool_file,
)

__all__ = [
    "Mempool",
    "dump_mempool",
    "load_mempool",
    "save_mempool",
    "sync_key",
    "write_mempool_file",
]
