"""Sparse embedding engine (port of shifu_tpu/embed/, the parts one GPU
needs): per-batch unique-id compaction (`dedup`).  Its kernels, the lookup
and the fused rows-touched update, live in ops/embedding.py;
train/sparse_embed.py wires them into the step.  Tiering (hot rows on the
card, the cold tail on the host) and vocab sharding wait for later slices
(ROADMAP.md queue A)."""

from .dedup import (INVERSE_KEY, UNIQUE_KEY, attach_dedup, dedup_ids,
                    dedup_lookup, host_ids)

__all__ = ["INVERSE_KEY", "UNIQUE_KEY", "attach_dedup", "dedup_ids",
           "dedup_lookup", "host_ids"]
