"""Sparse embedding engine (port of shifu_tpu/embed/): per-batch
unique-id compaction (`dedup`, with its journaled report), the
frequency-tiered table (`tiering`: hot rows in memory, the cold tail on a
host memmap) and vocab-sharded tables over a mesh's model axis
(`shard`).  Its kernels, the lookup and the fused rows-touched update,
live in ops/embedding.py; train/sparse_embed.py wires them into the
step."""

from .._lazy import exports
from .dedup import (INVERSE_KEY, UNIQUE_KEY, attach_dedup, dedup_ids,
                    dedup_lookup, host_ids)
from .tiering import TieredTable

# the vocab-sharded update loads with the mesh code it needs, on first use
__getattr__, _shard_all = exports(__name__, {
    "shard": ("VOCAB_SHARD_RULES", "assert_vocab_sharded",
              "make_sharded_rows_update"),
})
__all__ = ["INVERSE_KEY", "UNIQUE_KEY", "TieredTable", "attach_dedup",
           "dedup_ids", "dedup_lookup", "host_ids", *_shard_all]
