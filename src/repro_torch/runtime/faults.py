"""Fault-injection harness for the resilient training loop (scripted adversity;
port of ``repro.runtime.faults``, numpy only).

A ``FaultPlan`` is a step-indexed script of the failure modes the paper's
production story must survive, expressed either programmatically or through a
tiny text DSL (one event per ``;``/``,``-separated clause):

    slow@8:r3x4.0      owner slot 3 runs 4.0x slower starting at step 8
    unslow@24:r3       owner slot 3 recovers its nominal speed at step 24
    kill@30:r1         the host behind owner slot 1 is lost at step 30
    readd@40           a replacement host joins at step 40 (owner count +1)
    preempt@52         the whole job is preempted at step 52 and restarts
                       from its latest committed checkpoint

Owner ids refer to the slot numbering of the plan live when the event fires
(a kill renumbers the survivors, exactly as an elastic re-plan does).

``FaultInjector`` is the runtime half: the supervisor polls ``events_at`` at
the top of every step; ``kill``/``preempt`` surface as ``OwnerLost``/
``Preemption`` exceptions (modeling the abrupt control-flow of a real device
loss), while ``slow``/``unslow`` mutate the injector's per-owner speed
multipliers, which ``perturb`` applies to the measured per-owner step times
fed to the StragglerMonitor.  Slow factors persist across a preemption — a
degraded host is still degraded after the job restarts.

Consumed by ``runtime/resilient.py`` and ``tests/test_torch_resilience.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

KINDS = ("slow", "unslow", "kill", "readd", "preempt")
_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<step>\d+)"
    r"(?::r(?P<owner>\d+))?(?:x(?P<factor>\d+(?:\.\d+)?))?$")


class OwnerLost(RuntimeError):
    """The host behind one owner slot dropped out of the job."""

    def __init__(self, owner: int):
        super().__init__(f"owner slot {owner} lost")
        self.owner = owner


class Preemption(RuntimeError):
    """The whole job was preempted; resume from the latest checkpoint."""


@dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str               # one of KINDS
    owner: int = -1         # slot id for slow/unslow/kill
    factor: float = 1.0     # slowdown multiplier for 'slow'

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0 (got {self.step})")
        if self.kind in ("slow", "unslow", "kill") and self.owner < 0:
            raise ValueError(f"{self.kind!r} needs an owner slot (':rN')")
        if self.kind == "slow" and self.factor < 1.0:
            raise ValueError(
                f"slow factor must be >= 1.0 (got {self.factor}); use "
                "'unslow' to restore nominal speed")

    def spec(self) -> str:
        """The DSL clause that parses back to this event."""
        s = f"{self.kind}@{self.step}"
        if self.kind in ("slow", "unslow", "kill"):
            s += f":r{self.owner}"
        if self.kind == "slow":
            s += f"x{self.factor:g}"
        return s


class FaultPlan:
    """An ordered script of fault events, indexable by step."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the text DSL (see module docstring)."""
        events = []
        for clause in re.split(r"[;,]", spec):
            clause = clause.strip()
            if not clause:
                continue
            m = _EVENT_RE.match(clause)
            if m is None:
                raise ValueError(
                    f"bad fault clause {clause!r}; expected "
                    "'kind@step[:rOWNER][xFACTOR]' with kind in "
                    f"{KINDS}")
            events.append(FaultEvent(
                step=int(m.group("step")), kind=m.group("kind"),
                owner=int(m.group("owner") or -1),
                factor=float(m.group("factor") or 1.0)))
        return cls(events)

    def spec(self) -> str:
        return "; ".join(e.spec() for e in self.events)

    def at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def max_step(self) -> int:
        return max((e.step for e in self.events), default=-1)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan({self.spec()!r})"


class FaultInjector:
    """Runs a FaultPlan against a supervisor loop at run time.

    Each scripted event fires exactly once: a preemption rewinds the loop's
    step counter to the checkpointed step, and replayed steps must not
    re-raise the faults that already struck (the real-world analogue: the
    failure happened to the previous incarnation of the job).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired: set = set()
        self._slow: Dict[int, float] = {}       # owner slot -> multiplier

    def events_at(self, step: int) -> List[FaultEvent]:
        """Unfired events scheduled for ``step``; marks them fired and
        applies slow/unslow to the injector's multiplier table.  The caller
        handles kill/readd/preempt (they change loop topology).  At most ONE
        control event is returned per poll — the supervisor recovers from it
        and re-polls the same step, so stacked same-step faults strike one
        at a time (each against the already-recovered topology)."""
        out = []
        for ev in self.plan.at(step):
            if ev in self._fired:
                continue
            self._fired.add(ev)
            if ev.kind == "slow":
                self._slow[ev.owner] = ev.factor
            elif ev.kind == "unslow":
                self._slow.pop(ev.owner, None)
            out.append(ev)
            if ev.kind in ("kill", "readd", "preempt"):
                break
        return out

    def on_owner_renumber(self, killed: int) -> None:
        """A kill compacts slot ids: slots above the lost one shift down by
        one, and their slow factors follow the hosts they describe."""
        self._slow = {(r - 1 if r > killed else r): f
                      for r, f in self._slow.items() if r != killed}

    def multipliers(self, num_owners: int) -> np.ndarray:
        """Per-owner wall-time multipliers under the active slow faults."""
        mult = np.ones(num_owners)
        for r, f in self._slow.items():
            if 0 <= r < num_owners:
                mult[r] = f
        return mult

    def perturb(self, per_owner_seconds: np.ndarray) -> np.ndarray:
        per_owner_seconds = np.asarray(per_owner_seconds, dtype=float)
        return per_owner_seconds * self.multipliers(len(per_owner_seconds))
