"""The data plane (port of shifu_tpu/data/): the reader's tiers, the
parse-once cache, the train/valid split and the pipeline from files to
batches.  The names load on first use, so that the operator's views,
which import parts of this package, stay light."""

from .._lazy import exports

__getattr__, __all__ = exports(__name__, {
    "cache": ("read_file_cached", "resolve_cache_dir"),
    "pipeline": ("TabularDataset", "batch_iterator", "load_datasets",
                 "num_batches", "pad_to_batch"),
    "reader": ("count_rows", "list_data_files", "open_maybe_gzip",
               "parse_rows", "project_columns", "read_file", "read_files",
               "shard_paths"),
    "split": ("bagging_mask", "row_uniform", "train_valid_mask"),
})
