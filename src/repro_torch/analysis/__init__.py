"""Static analysis for compiled crossbar programs and the port itself.

Port of ``repro/analysis``.  Three passes, one diagnostics currency:

* :mod:`repro_torch.analysis.verify` — an execution-free program verifier
  over ``BlockPatternWeight`` / ``CompiledNetwork`` / ``NetworkPartition``
  / serialized manifests (rules ``V1xx``–``V4xx``, ``M0xx``).  Runs at
  the trust boundaries: ``compile_network(options=CompileOptions(
  verify=...))`` and ``load_program(verify=True)``.
* :mod:`repro_torch.analysis.ranges` — the range & bit-width
  certification pass (rules ``V5xx``): an abstract interpreter that
  propagates interval bounds through the compiled schedule and proves
  accumulator and cell-budget facts about the quantized path, emitting a
  :class:`~repro_torch.analysis.ranges.RangeCertificate` that
  ``hardware_report()`` prices and manifest v4 persists.
* :mod:`repro_torch.analysis.lint` — an AST lint over ``src/repro_torch/``
  (rules ``L002``, ``L003``, ``L004``, ``L006``) enforcing tracer
  discipline, immutable defaults, synchronized timing and lock
  discipline in CI.

CLI::

    python -m repro_torch.analysis verify <saved-program-dir> [--json]
    python -m repro_torch.analysis ranges <saved-program-dir> [--json]
    python -m repro_torch.analysis lint [paths...] [--json]
    python -m repro_torch.analysis all <saved-program-dir> [--paths ...]

(exit codes documented in :mod:`repro_torch.analysis.__main__`).
"""

from repro_torch.analysis.diagnostics import (
    ERROR,
    WARNING,
    Diagnostic,
    ProgramFormatError,
    Report,
    VerificationError,
)

__all__ = [
    "Diagnostic",
    "Report",
    "ProgramFormatError",
    "VerificationError",
    "ERROR",
    "WARNING",
]
