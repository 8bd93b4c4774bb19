"""Structured diagnostics for the static program verifier and the lint.

Port of ``repro/analysis/diagnostics.py`` (pure Python, copied).  One
:class:`Diagnostic` is one violated rule at one location: a stable rule
id (``V1xx`` operand rules, ``V2xx`` layer rules, ``V3xx`` network
rules, ``V4xx`` partition rules, ``V5xx`` range rules, ``M0xx`` manifest
rules, ``L0xx`` lint rules), a severity (``error`` means the program
must not run / the code must not merge; ``warning`` means suspicious but
executable), and enough location context (layer, field path, file:line)
to act on it without re-running the verifier.

:class:`Report` collects diagnostics and is the single currency between
the rule passes (``analysis/verify.py``, ``analysis/ranges.py``,
``analysis/lint.py``), their call sites at the trust boundaries
(``compile_network(options=CompileOptions(verify=...))``,
``serialize.load_program(verify=...)``), and the ``python -m
repro_torch.analysis`` CLI (which renders it as text or JSON).

This module imports nothing of the port on purpose:
``engine/serialize.py`` takes :class:`ProgramFormatError` from here
without pulling the verifier (and its ``engine`` imports) into its own
import graph.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = [
    "Diagnostic",
    "Report",
    "ProgramFormatError",
    "VerificationError",
    "ERROR",
    "WARNING",
]

ERROR = "error"
WARNING = "warning"


class ProgramFormatError(ValueError):
    """A serialized program's manifest or payload is malformed.

    Raised by ``engine/serialize.load_program`` *before* any array is
    constructed, so a corrupt or truncated file surfaces as one clear
    error naming the offending manifest field instead of an opaque
    ``KeyError``/``ValueError`` from the middle of the load.  Carries
    the manifest rule id (``M001`` unreadable, ``M002`` bad version,
    ``M003`` missing/ill-typed keys, ``M004`` missing payload files,
    ``M005`` payload load failure) so :func:`repro_torch.analysis.
    verify.verify_manifest` can report it as a diagnostic.
    """

    def __init__(self, message: str, rule: str = "M003"):
        super().__init__(message)
        self.rule = rule


class VerificationError(ValueError):
    """A program failed static verification; carries the full report."""

    def __init__(self, message: str, report: "Report"):
        super().__init__(message + "\n" + report.format())
        self.report = report


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One rule violation at one location."""

    rule: str  # stable id, e.g. "V101"
    severity: str  # ERROR | WARNING
    message: str
    layer: str | None = None  # "conv1", "fc", or None for network scope
    location: str | None = None  # field path or file:line

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "layer": self.layer,
            "location": self.location,
        }

    def format(self) -> str:
        where = ":".join(p for p in (self.layer, self.location) if p)
        prefix = f"{self.severity.upper()} {self.rule}"
        return f"{prefix} [{where}] {self.message}" if where else \
            f"{prefix} {self.message}"


class Report:
    """An ordered collection of diagnostics with an error/warning split."""

    def __init__(self, diagnostics: list[Diagnostic] | None = None):
        self.diagnostics: list[Diagnostic] = list(diagnostics or [])

    def add(
        self,
        rule: str,
        message: str,
        severity: str = ERROR,
        layer: str | None = None,
        location: str | None = None,
    ) -> Diagnostic:
        d = Diagnostic(rule, severity, message, layer, location)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        return self

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No errors (warnings are allowed)."""
        return not self.errors

    @property
    def clean(self) -> bool:
        """No diagnostics at all."""
        return not self.diagnostics

    def rules(self, severity: str | None = None) -> set[str]:
        """The distinct rule ids present, optionally filtered by severity."""
        return {
            d.rule
            for d in self.diagnostics
            if severity is None or d.severity == severity
        }

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "diagnostics": [d.to_json() for d in self.diagnostics],
        }

    def format(self) -> str:
        if not self.diagnostics:
            return "clean: no diagnostics"
        lines = [d.format() for d in self.diagnostics]
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)"
        )
        return "\n".join(lines)

    def raise_if_errors(self, context: str) -> "Report":
        """Raise :class:`VerificationError` when any error diagnostic
        exists; returns ``self`` otherwise (chainable)."""
        if self.errors:
            raise VerificationError(
                f"{context}: {len(self.errors)} verification error(s)", self
            )
        return self

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2)
