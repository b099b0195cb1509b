"""The port's operator tools, each run as `python -m
shifu_tpu_torch.tools.<name>` (the counterparts of the repo's `tools/`):

- `trace_diff`: per-kernel device-time deltas between two
  `device_profile` rollups, and the serving- and pod-plane axis diffs;
- `profile_staged`: the staged input tier's per-chunk phase split
  (assemble, put, dispatch, sync) per wire format, prefetched epoch
  walls and a host-to-card probe, on the card;
- `loadtest`: the open-loop Poisson harness of the scoring daemon.

Each module is import-safe: its `main(argv)` runs only under
`if __name__ == "__main__"`.
"""
