"""Typed findings and reports, on the ``repro_torch.obs`` event
conventions — the reference's ``src/repro/analysis/report.py`` record for
record.

A :class:`Finding` is one violated invariant; a :class:`Report` is one
verification run (a config key, the passes that ran, the findings that
survived, or the error that prevented analysis). Both are frozen
dataclasses with a ``kind`` ClassVar — the same shape as
:mod:`repro_torch.obs.events` events, so ``obs_events.emit(finding)``
works and the JSONL serialisation is line-per-record with the same field
layout the ``OBS_*.jsonl`` artifacts use. ``Report.to_jsonl`` /
:func:`load_report` round-trip losslessly, and each package reads the
other's files (pinned in ``tests/test_torch_analysis.py``). A finding's
``grid_step`` is the (launch, block, item) of its first occurrence.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import ClassVar, Optional, Tuple

from repro_torch.obs import events as obs_events


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated kernel invariant, attributed to one verifier pass."""

    kind: ClassVar[str] = "finding"
    passname: str                 # dma_pairing | bank_hazard | read_once |
                                  # width_lint | vmem_budget
    message: str                  # what is wrong, in words, with numbers
    key: str                      # config key (executor/dtype/border/...)
    severity: str = "error"
    ref: Optional[str] = None     # shared-memory/operand role involved
    grid_step: Optional[Tuple[int, ...]] = None  # first (launch, block, item)
    count: int = 1                # occurrences across the grid sweep
    detail: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Report:
    """One verification run over one traced configuration."""

    kind: ClassVar[str] = "verify_report"
    key: str
    passes: Tuple[str, ...] = ()
    findings: Tuple[Finding, ...] = ()
    error: Optional[str] = None   # a failure before the passes (nothing ran)
    stats: Tuple[Tuple[str, float], ...] = ()

    @property
    def clean(self) -> bool:
        return not self.findings and self.error is None

    def stat(self, name: str) -> Optional[float]:
        for k, v in self.stats:
            if k == name:
                return v
        return None

    def merge(self, other: "Report") -> "Report":
        """Fold another config's report into this one (sweep aggregation):
        findings concatenate, passes union, the first error wins."""
        return Report(
            key=self.key,
            passes=self.passes + tuple(p for p in other.passes
                                       if p not in self.passes),
            findings=self.findings + other.findings,
            error=self.error or other.error,
            stats=self.stats + other.stats)

    # -- serialisation (obs JSONL conventions) ----------------------------

    def to_records(self) -> list:
        """One header record + one record per finding, ``seq``/``t``/
        ``kind``-framed exactly like the obs Trace sink writes them."""
        t = time.time()
        recs = [obs_events._to_record(1, t, self)]
        for i, f in enumerate(self.findings):
            recs.append(obs_events._to_record(2 + i, t, f))
        return recs

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            for rec in self.to_records():
                fh.write(json.dumps(rec) + "\n")

    def emit(self) -> None:
        """Send the report (and each finding) through the obs trace when
        tracing is on — a no-op branch otherwise."""
        if obs_events.enabled():
            obs_events.emit(self)
            for f in self.findings:
                obs_events.emit(f)

    # -- rendering ---------------------------------------------------------

    def render(self) -> str:
        head = f"verify {self.key}: "
        if self.error is not None:
            lines = [head + "TRACE ERROR", f"  {self.error}"]
        elif not self.findings:
            lines = [head + f"clean ({len(self.passes)} passes: "
                     + ", ".join(self.passes) + ")"]
        else:
            lines = [head + f"{len(self.findings)} finding(s)"]
            for f in self.findings:
                loc = (f" @ grid{tuple(f.grid_step)}"
                       if f.grid_step is not None else "")
                n = f" x{f.count}" if f.count > 1 else ""
                lines.append(f"  [{f.passname}]{loc}{n} {f.message}")
                if f.detail:
                    lines.append(f"      {f.detail}")
        return "\n".join(lines)


def _tupled(v):
    return tuple(v) if isinstance(v, list) else v


def load_report(path: str) -> Report:
    """Rebuild a :class:`Report` from its ``to_jsonl`` file."""
    header, findings = None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("kind", None)
            rec.pop("seq", None)
            rec.pop("t", None)
            if kind == Report.kind:
                header = rec
            elif kind == Finding.kind:
                rec["grid_step"] = _tupled(rec.get("grid_step"))
                findings.append(Finding(**rec))
            else:
                raise ValueError(f"unknown record kind {kind!r} in {path}")
    if header is None:
        raise ValueError(f"no {Report.kind!r} header record in {path}")
    header.pop("findings", None)
    return Report(passes=tuple(header.pop("passes", ())),
                  stats=tuple((k, v) for k, v in header.pop("stats", ())),
                  findings=tuple(findings), **header)
