"""Compile pattern-pruned CNNs into block-pattern programs and serve them.

``compile_network`` lowers params to a ``CompiledNetwork``;
``save_program``/``load_program`` persist it in the reference's format;
``make_forward``/``execute`` run it; ``InferenceService`` serves it with
continuous batching; ``CompiledNetwork.hardware_report`` (and
``InferenceService.hardware_report`` for the traffic served) prices it
on the paper's crossbar model.  ``compile_network(options=
CompileOptions(optimize="auto"))`` runs the per-layer mapping search;
``CompileOptions(verify="strict")`` verifies the program and certifies
its value ranges (``repro_torch.analysis``), and ``load_program``
verifies by default.
"""

from repro_torch.analysis.diagnostics import (
    Diagnostic,
    Report,
    VerificationError,
)
from repro_torch.analysis.ranges import RangeCertificate
from repro_torch.core.mapping import MappingCandidate
from repro_torch.core.mapsearch import (
    MappingSearchConfig,
    MappingSearchResult,
    search_layer_mapping,
)

from repro_torch.engine.executor import (
    execute,
    extract_patches,
    make_forward,
    warmup_forward,
)
from repro_torch.engine.lowering import (
    PRECISIONS,
    CompileOptions,
    EngineConfig,
    compile_network,
    conv_mapping_search,
    lower_matrix,
)
from repro_torch.engine.partition import NetworkPartition, tile_assignment
from repro_torch.engine.program import CompiledConv, CompiledFC, CompiledNetwork
from repro_torch.engine.scheduler import SchedulerFull, SlotScheduler
from repro_torch.engine.serialize import (
    ProgramFormatError,
    load_program,
    read_manifest,
    save_program,
    validate_manifest,
)
from repro_torch.engine.service import InferenceService
from repro_torch.engine.stats import ActivationStats, LayerSkipStats

__all__ = [
    "PRECISIONS",
    "ActivationStats",
    "CompileOptions",
    "CompiledConv",
    "CompiledFC",
    "CompiledNetwork",
    "Diagnostic",
    "EngineConfig",
    "InferenceService",
    "LayerSkipStats",
    "MappingCandidate",
    "MappingSearchConfig",
    "MappingSearchResult",
    "NetworkPartition",
    "ProgramFormatError",
    "RangeCertificate",
    "Report",
    "SchedulerFull",
    "SlotScheduler",
    "VerificationError",
    "compile_network",
    "conv_mapping_search",
    "execute",
    "extract_patches",
    "load_program",
    "lower_matrix",
    "make_forward",
    "read_manifest",
    "save_program",
    "search_layer_mapping",
    "tile_assignment",
    "validate_manifest",
    "warmup_forward",
]
