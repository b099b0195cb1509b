"""What a driver is handed for one run, and the clock it keeps."""

from __future__ import annotations

import dataclasses
import time
from typing import Any


@dataclasses.dataclass
class Session:
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: Any            # torch.device the program runs on
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json, with any overrides
    t_start: float         # time.perf_counter() when the process began
    tmpdir: str            # a fresh directory under TMPDIR, removed after
    # (step of set-up, seconds since t_start when it ended), for stderr
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t_start))

    def now(self) -> float:
        return time.perf_counter()

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak_bytes(self) -> int:
        import torch
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
