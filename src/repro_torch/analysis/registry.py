"""Declarative rule registry shared by every analysis layer (the JAX
package's ``analysis/registry.py``, unchanged in function).

An *audit* is a zero-arg callable returning a list of ``Violation``s.
Layers register theirs with the ``@audit("name")`` decorator at import
time; the CLI (``python -m repro_torch.analysis``) imports the layer
modules and runs the registry.  The registry stays dumb (name ->
callable), so a new rule family is one decorated function away.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

AuditFn = Callable[[], List["Violation"]]

AUDITS: Dict[str, AuditFn] = {}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule failure.

    rule:   dotted rule id, e.g. "ops.dispatch-buffer": stable names that
            tests and exemptions key on.
    entry:  what was audited (hot entrypoint, kernel function, file:line).
    detail: human-readable specifics (shapes, bytes, op names).
    """
    rule: str
    entry: str
    detail: str

    def __str__(self) -> str:
        return f"{self.rule} @ {self.entry}: {self.detail}"


def audit(name: str) -> Callable[[AuditFn], AuditFn]:
    """Register ``fn`` as the audit called ``name`` (one per name)."""
    def register(fn: AuditFn) -> AuditFn:
        if name in AUDITS:
            raise ValueError(f"duplicate audit {name!r}")
        AUDITS[name] = fn
        return fn
    return register


def run_audits(names: Optional[Iterable[str]] = None,
               report: Optional[Callable[[str, List[Violation]], None]]
               = None) -> List[Violation]:
    """Run the selected audits (all when ``names`` is None) in
    registration order; ``report(name, violations)`` fires after each so
    the CLI can stream progress."""
    picked = list(AUDITS) if names is None else list(names)
    unknown = [n for n in picked if n not in AUDITS]
    if unknown:
        raise KeyError(f"unknown audits {unknown}; have {sorted(AUDITS)}")
    out: List[Violation] = []
    for name in picked:
        vs = AUDITS[name]()
        if report is not None:
            report(name, vs)
        out.extend(vs)
    return out
