"""Chaos plan schema: the declarative description of which faults fire where
(the port's copy of shifu_tpu/chaos/plan.py; the same grammar, the same
environment variables, the same messages).

A plan is JSON — inline in SHIFU_TPU_CHAOS_PLAN / `--chaos-plan`, or a path
to a JSON file, local or remote (read through data/fsio.py):

    {
      "seed": 7,
      "faults": [
        {"site": "train.epoch", "at_epoch": 1, "action": "exit",
         "exit_code": 17, "scope": "job", "max_times": 1},
        {"site": "checkpoint.restore", "at_call": 1, "scope": "job",
         "action": "raise"},
        {"site": "fsio.read_bytes", "every": 3, "action": "raise"}
      ]
    }

Each fault names a **site** — an explicit `chaos.maybe_fail("site.name")`
probe compiled into the production code (the port's sites: chaos/__init__.py) —
and **triggers** that are all deterministic, so a chaos run is replayable:

- ``at_call=N``   fire on the Nth probe call of this site (1-based)
- ``every=N``     fire on every Nth probe call
- ``at_epoch=K``  fire when the probe's ``epoch`` context equals K
- ``before_epoch=N``  fire while ``epoch`` < N (repeated-preemption drills)
- ``rank=i``      only on gang rank i (SHIFU_TPU_PROCESS_ID)
- ``prob=p``      seeded counter-hashed coin flip: the injection sequence is
                  a pure function of (seed, site, call number) — two runs of
                  the same plan+seed inject at identical calls
- ``max_times=M`` stop after M injections of this fault
- ``scope``       "process" (default: call/fire counters reset per process)
                  or "job" (counters persist across supervised restarts in
                  the SHIFU_TPU_CHAOS_STATE file, so "the first restore of
                  the JOB fails" is expressible)

Actions: ``raise`` (a ChaosError, an OSError subclass — exercises retry and
fallback paths), ``exit`` (os._exit(exit_code) — a hard crash), ``hang``
(stall forever — exercises liveness monitors), ``corrupt`` (flip bytes in
the file tree the probe passes as ``path`` context — exercises checkpoint
digest verification), ``delay`` (sleep ``delay_s`` seconds then continue —
a SLOWDOWN, not a failure: exercises latency monitors like the serving SLO
engine's burn-rate alerting at the `runtime.serve.dispatch` probe).

The legacy SHIFU_TPU_FAULT_* / SHIFU_TPU_HANG_EPOCH env hooks synthesize an
equivalent plan (`plan_from_legacy_env`), so pre-chaos drills keep working
unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional

ENV_CHAOS_PLAN = "SHIFU_TPU_CHAOS_PLAN"
ENV_CHAOS_STATE = "SHIFU_TPU_CHAOS_STATE"

ACTIONS = ("raise", "exit", "hang", "corrupt", "delay")
SCOPES = ("process", "job")


class ChaosPlanError(ValueError):
    """A malformed chaos plan — raised at load, never mid-run."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault: a site pattern plus deterministic triggers."""

    site: str                 # exact site name or fnmatch glob ("fsio.*")
    action: str = "raise"
    at_call: int = 0          # 1-based Nth probe call; 0 = off
    every: int = 0            # every Nth probe call; 0 = off
    at_epoch: int = -1        # fire when ctx epoch == K; -1 = off
    before_epoch: int = -1    # fire while ctx epoch < N; -1 = off
    rank: int = -1            # only on this gang rank; -1 = any
    member: str = ""          # only when the probe's `member` context
                              # matches this fnmatch pattern ("" = any) —
                              # fleet drills silence ONE member's lease
                              # or sync without touching its peers
    prob: float = 0.0         # seeded per-call probability; 0 = off
    max_times: int = 0        # stop after M injections; 0 = unlimited
    scope: str = "process"
    exit_code: int = 17
    delay_s: float = 0.1      # sleep length of the `delay` action
    message: str = ""         # echoed on injection ({site}/{epoch}/{rank}
                              # format fields available)

    def validate(self) -> "FaultSpec":
        """Checked AND coerced copy: every numeric field becomes a real
        int/float here, at load — a JSON plan with `"rank": "2"` must fail
        or coerce NOW, never TypeError inside a probe mid-run (the module
        contract is that malformed plans never fire late)."""
        if not self.site or not isinstance(self.site, str):
            raise ChaosPlanError(f"fault needs a non-empty site: {self!r}")
        if self.action not in ACTIONS:
            raise ChaosPlanError(
                f"fault {self.site!r}: unknown action {self.action!r} "
                f"(one of {ACTIONS})")
        if self.scope not in SCOPES:
            raise ChaosPlanError(
                f"fault {self.site!r}: unknown scope {self.scope!r} "
                f"(one of {SCOPES})")
        coerced = {}
        for field, cast in (("at_call", int), ("every", int),
                            ("at_epoch", int), ("before_epoch", int),
                            ("rank", int), ("max_times", int),
                            ("exit_code", int), ("prob", float),
                            ("delay_s", float)):
            try:
                coerced[field] = cast(getattr(self, field))
            except (TypeError, ValueError):
                raise ChaosPlanError(
                    f"fault {self.site!r}: {field} must be a "
                    f"{cast.__name__}, got {getattr(self, field)!r}")
        if not isinstance(self.message, str):
            raise ChaosPlanError(f"fault {self.site!r}: message must be a "
                                 "string")
        if not isinstance(self.member, str):
            raise ChaosPlanError(f"fault {self.site!r}: member must be a "
                                 "string (fnmatch pattern)")
        spec = dataclasses.replace(self, **coerced)
        if not (0.0 <= spec.prob <= 1.0):
            raise ChaosPlanError(
                f"fault {self.site!r}: prob must be in [0, 1]")
        if spec.delay_s < 0:
            raise ChaosPlanError(
                f"fault {self.site!r}: delay_s must be >= 0")
        if (spec.at_call <= 0 and spec.every <= 0 and spec.at_epoch < 0
                and spec.before_epoch < 0 and spec.prob <= 0.0):
            raise ChaosPlanError(
                f"fault {self.site!r}: no trigger (set at_call / every / "
                "at_epoch / before_epoch / prob)")
        return spec


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    faults: tuple[FaultSpec, ...] = ()
    seed: int = 0

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }, indent=indent)


_FAULT_FIELDS = {f.name for f in dataclasses.fields(FaultSpec)}


def parse_plan(obj) -> ChaosPlan:
    """ChaosPlan from a decoded JSON object (dict with "faults", or a bare
    list of fault dicts).  Raises ChaosPlanError with the field spelled out
    — a typo'd trigger must fail the launch, not silently never fire."""
    if isinstance(obj, list):
        obj = {"faults": obj}
    if not isinstance(obj, Mapping):
        raise ChaosPlanError(f"chaos plan must be a JSON object, got "
                             f"{type(obj).__name__}")
    raw_faults = obj.get("faults", [])
    if not isinstance(raw_faults, (list, tuple)):
        raise ChaosPlanError("chaos plan 'faults' must be a list")
    faults = []
    for i, rf in enumerate(raw_faults):
        if not isinstance(rf, Mapping):
            raise ChaosPlanError(f"fault #{i} must be an object")
        unknown = set(rf) - _FAULT_FIELDS
        if unknown:
            raise ChaosPlanError(
                f"fault #{i} ({rf.get('site', '?')!r}): unknown field(s) "
                f"{sorted(unknown)} (known: {sorted(_FAULT_FIELDS)})")
        try:
            spec = FaultSpec(**rf).validate()
        except TypeError as e:
            raise ChaosPlanError(f"fault #{i}: {e}") from e
        faults.append(spec)
    try:
        seed = int(obj.get("seed", 0))
    except (TypeError, ValueError):
        raise ChaosPlanError("chaos plan 'seed' must be an integer")
    return ChaosPlan(faults=tuple(faults), seed=seed)


def load_plan(source: str) -> ChaosPlan:
    """Plan from an inline JSON string (starts with '{' or '[') or a path
    (local, or remote through data/fsio)."""
    text = source.strip()
    if not text.startswith("{") and not text.startswith("["):
        try:
            from ..data import fsio
            if fsio.is_remote(text):
                raw = fsio.read_bytes(text).decode("utf-8")
            else:
                with open(text) as f:
                    raw = f.read()
        except OSError as e:
            raise ChaosPlanError(f"cannot read chaos plan {text!r}: {e}")
        text = raw
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise ChaosPlanError(f"chaos plan is not valid JSON: {e}")
    return parse_plan(obj)


# ---------------------------------------------------------------------------
# Legacy env-hook compatibility shim.  The four SHIFU_TPU_FAULT_* hooks (and
# SHIFU_TPU_HANG_EPOCH) predate the chaos plane; they synthesize plan
# entries so every consumer — injection, journaling, chaos-verify — sees one
# mechanism.  Messages match the legacy prints byte-for-byte: the resilience
# tests (and any operator tooling grepping logs) assert on them.

LEGACY_FAULT_EPOCH = "SHIFU_TPU_FAULT_EPOCH"
LEGACY_FAULT_EVERY_EPOCH = "SHIFU_TPU_FAULT_EVERY_EPOCH"
LEGACY_FAULT_PROCESS = "SHIFU_TPU_FAULT_PROCESS"
LEGACY_FAULT_HOST_DOWN = "SHIFU_TPU_FAULT_HOST_DOWN"
LEGACY_HANG_EPOCH = "SHIFU_TPU_HANG_EPOCH"

_LEGACY_KILL_MSG = "FAULT INJECTION: killing process after epoch {epoch}"


def plan_from_legacy_env(environ: Optional[Mapping[str, str]] = None
                         ) -> tuple[FaultSpec, ...]:
    """FaultSpecs synthesized from the legacy env hooks (empty when unset)."""
    env = os.environ if environ is None else environ

    def _int(name: str) -> Optional[int]:
        raw = env.get(name)
        if raw is None:
            return None
        try:
            return int(raw)
        except ValueError:
            return None

    rank = _int(LEGACY_FAULT_PROCESS)
    rank = -1 if rank is None else rank
    out: list[FaultSpec] = []
    k = _int(LEGACY_FAULT_EPOCH)
    if k is not None:
        out.append(FaultSpec(site="train.epoch", at_epoch=k, rank=rank,
                             action="exit", exit_code=17,
                             message=_LEGACY_KILL_MSG))
    n = _int(LEGACY_FAULT_EVERY_EPOCH)
    if n is not None:
        out.append(FaultSpec(site="train.epoch", before_epoch=n, rank=rank,
                             action="exit", exit_code=17,
                             message=_LEGACY_KILL_MSG))
    h = _int(LEGACY_HANG_EPOCH)
    if h is not None:
        out.append(FaultSpec(
            site="train.epoch", at_epoch=h, rank=rank, action="hang",
            message="HANG INJECTION: stalling after epoch {epoch}"))
    d = _int(LEGACY_FAULT_HOST_DOWN)
    if d is not None:
        out.append(FaultSpec(
            site="launcher.start", rank=d, every=1, action="exit",
            exit_code=1,
            message=f"FAULT INJECTION: host (rank {d}) is permanently down"))
    return tuple(out)


def load_plan_env(environ: Optional[Mapping[str, str]] = None
                  ) -> Optional[ChaosPlan]:
    """The active plan from the environment: SHIFU_TPU_CHAOS_PLAN merged
    with the legacy hook shim; None when neither is present."""
    env = os.environ if environ is None else environ
    base: Optional[ChaosPlan] = None
    src = env.get(ENV_CHAOS_PLAN)
    if src:
        base = load_plan(src)
    legacy = plan_from_legacy_env(env)
    if base is None and not legacy:
        return None
    if base is None:
        return ChaosPlan(faults=legacy)
    return ChaosPlan(faults=base.faults + legacy, seed=base.seed)
