"""Persist compiled programs so compilation is paid once per model.

Port of ``repro/engine/serialize.py``: the same on-disk layout, so a
program saved by either package loads in the other.  One ``.npy`` per
array plus a fsynced ``program.json`` manifest, written into a ``.tmp``
directory and ``os.replace``d only when complete.  The round trip is
bit-exact (float payloads as float32, quantized payloads as int8 with
float32 scales, index streams as int32/int64).  Formats v1–v4 load; v4
is written.  The optional per-conv ``mapping`` (v3,
:class:`~repro_torch.core.mapping.MappingCandidate`), ``partition``
(:class:`~repro_torch.engine.partition.NetworkPartition`) and range
``certificate`` (v4,
:class:`~repro_torch.analysis.ranges.RangeCertificate`) load as those
objects and save back to the same manifest entries; only their structure
is checked here (M003).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.analysis.ranges import RangeCertificate
from repro_torch.core.mapping import MappingCandidate
from repro_torch.core.sparse import BlockPatternWeight
from repro_torch.device import resolve_device
from repro_torch.engine.partition import NetworkPartition
from repro_torch.engine.program import CompiledConv, CompiledFC, CompiledNetwork
from repro_torch.models.cnn import CNNConfig

__all__ = [
    "save_program",
    "load_program",
    "read_manifest",
    "validate_manifest",
    "ProgramFormatError",
]

_MANIFEST = "program.json"
# v2 adds precision/cell_bits + per-bp w_scales; v3 adds per-conv
# mapping candidates + the fc reorder tag; v4 adds the optional range
# certificate
_FORMAT_VERSION = 4
_SUPPORTED_VERSIONS = (1, 2, 3, 4)


class ProgramFormatError(ValueError):
    """A serialized program's manifest or payload is malformed.

    Raised by :func:`load_program` *before* any array is constructed.
    Carries the manifest rule id (``M001`` unreadable, ``M002`` bad
    version, ``M003`` missing/ill-typed keys, ``M004`` missing payload
    files, ``M005`` payload load failure).
    """

    def __init__(self, message: str, rule: str = "M003"):
        super().__init__(message)
        self.rule = rule


def _save_array(directory: str, name: str, arr) -> str:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    fname = f"{name}.npy"
    with open(os.path.join(directory, fname), "wb") as f:
        np.save(f, np.asarray(arr))
        f.flush()
        os.fsync(f.fileno())
    return fname


def _bp_manifest(prefix: str, bp: BlockPatternWeight, directory: str) -> dict:
    fields = ["w_comp", "block_ids", "nnz", "new_order", "inv_order",
              "dict_masks"]
    if bp.w_scales is not None:
        fields.append("w_scales")
    return {
        "k_in": bp.k_in,
        "n_out": bp.n_out,
        "block": bp.block,
        "tile": bp.tile,
        "arrays": {
            field: _save_array(directory, f"{prefix}.{field}", getattr(bp, field))
            for field in fields
        },
    }


def _load_bp(entry: dict, directory: str, device) -> BlockPatternWeight:
    def arr(field):
        return np.load(os.path.join(directory, entry["arrays"][field]))

    def tensor(field):
        return torch.from_numpy(arr(field)).to(device)

    has_scales = "w_scales" in entry["arrays"]
    return BlockPatternWeight(
        w_comp=tensor("w_comp"),
        block_ids=tensor("block_ids"),
        nnz=arr("nnz"),
        new_order=arr("new_order"),
        inv_order=arr("inv_order"),
        k_in=int(entry["k_in"]),
        n_out=int(entry["n_out"]),
        block=int(entry["block"]),
        tile=int(entry["tile"]),
        dict_masks=arr("dict_masks"),
        w_scales=tensor("w_scales") if has_scales else None,
    )


def save_program(directory: str, program: CompiledNetwork) -> str:
    """Atomically write ``program`` under ``directory``.  Returns the path."""
    parent = os.path.dirname(os.path.abspath(directory))
    os.makedirs(parent, exist_ok=True)
    tmp = directory.rstrip("/") + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    cfg = program.config
    manifest = {
        "format_version": _FORMAT_VERSION,
        "block": program.block,
        "tile": program.tile,
        "precision": program.precision,
        "cell_bits": program.cell_bits,
        "config": {
            "conv_channels": [list(c) for c in cfg.conv_channels],
            "pool_after": sorted(cfg.pool_after),
            "num_classes": cfg.num_classes,
            "input_hw": cfg.input_hw,
            "kernel": cfg.kernel,
        },
        "convs": [],
    }
    if program.partition is not None:
        manifest["partition"] = program.partition.to_manifest()
    if program.certificate is not None:
        manifest["certificate"] = program.certificate.to_manifest()
    for c in program.convs:
        manifest["convs"].append(
            {
                "name": c.name,
                "c_in": c.c_in,
                "c_out": c.c_out,
                "kernel": c.kernel,
                "out_hw": c.out_hw,
                "pool_after": c.pool_after,
                "bias": _save_array(tmp, f"{c.name}.bias", c.bias),
                "pattern_bits": _save_array(
                    tmp, f"{c.name}.pattern_bits", c.pattern_bits
                ),
                "bp": _bp_manifest(c.name, c.bp, tmp),
                "mapping": (
                    None if c.mapping is None else c.mapping.to_manifest()
                ),
            }
        )
    manifest["fc"] = {
        "d_in": program.fc.d_in,
        "d_out": program.fc.d_out,
        "bias": _save_array(tmp, "fc.bias", program.fc.bias),
        "bp": _bp_manifest("fc", program.fc.bp, tmp),
        "reorder": program.fc.reorder,
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    # never delete the previous program before the new one is in place:
    # move it aside, swap in the new directory, then drop the old copy
    old = directory.rstrip("/") + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.replace(directory, old)
    os.replace(tmp, directory)
    if os.path.exists(old):
        shutil.rmtree(old)
    return directory


def _resolve_directory(directory: str) -> str:
    """Fall back to ``<directory>.old`` when the target has no manifest —
    a save interrupted between the two swap renames leaves the previous
    complete program there."""
    if not os.path.exists(os.path.join(directory, _MANIFEST)):
        old = directory.rstrip("/") + ".old"
        if os.path.exists(os.path.join(old, _MANIFEST)):
            return old
    return directory


def read_manifest(directory: str) -> dict:
    """Read the manifest JSON, raising :class:`ProgramFormatError` (M001)
    instead of an opaque OSError/JSONDecodeError."""
    path = os.path.join(_resolve_directory(directory), _MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except OSError as e:
        raise ProgramFormatError(
            f"program manifest unreadable: {path}: {e}", rule="M001"
        ) from e
    except ValueError as e:
        raise ProgramFormatError(
            f"program manifest is not valid JSON: {path}: {e}", rule="M001"
        ) from e
    if not isinstance(manifest, dict):
        raise ProgramFormatError(
            f"program manifest is not a JSON object: {path}", rule="M001"
        )
    return manifest


_BP_ARRAY_FIELDS = ("w_comp", "block_ids", "nnz", "new_order", "inv_order",
                    "dict_masks")
_CONFIG_KEYS = ("conv_channels", "pool_after", "num_classes", "input_hw",
                "kernel")
_CONV_KEYS = ("name", "c_in", "c_out", "kernel", "out_hw", "pool_after",
              "bias", "pattern_bits", "bp")
_MAPPING_KEYS = ("rows", "cols", "cells_per_weight", "ou_rows", "ou_cols",
                 "block_order", "reorder")
_CERT_KEYS = ("input_lo", "input_hi", "precision", "cell_bits",
              "fp32_safe", "layers")
_CERT_LAYER_KEYS = ("name", "pre_lo", "pre_hi", "act_lo", "act_hi")


def _fail(message: str, rule: str = "M003"):
    raise ProgramFormatError(message, rule=rule)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _require(entry: dict, keys, where: str) -> None:
    missing = [k for k in keys if k not in entry]
    if missing:
        _fail(f"program manifest {where} is missing key(s) "
              f"{', '.join(missing)}")


def _require_file(fname, directory: str, where: str) -> None:
    if not isinstance(fname, str) or not os.path.exists(
        os.path.join(directory, fname)
    ):
        _fail(f"payload file for {where} missing: {fname!r}", rule="M004")


def _check_mapping_entry(entry, where: str) -> None:
    """Structural (M003) check of a v3 ``mapping`` entry: keys and types
    only; the tags' validity is the verifier's job."""
    if entry is None:
        return
    if not isinstance(entry, dict):
        _fail(f"program manifest {where} must be an object or null")
    _require(entry, _MAPPING_KEYS, where)
    for k in ("rows", "cols", "cells_per_weight", "ou_rows", "ou_cols"):
        if not _is_int(entry[k]):
            _fail(f"program manifest {where}.{k} must be an integer")
    for k in ("block_order", "reorder"):
        if not isinstance(entry[k], str):
            _fail(f"program manifest {where}.{k} must be a string")


def _check_certificate_entry(entry, where: str) -> None:
    """Structural (M003) check of a v4 range ``certificate`` entry: keys
    and types only; whether it matches the payloads is the certification
    pass's job."""
    if entry is None:
        return
    if not isinstance(entry, dict):
        _fail(f"program manifest {where} must be an object or null")
    _require(entry, _CERT_KEYS, where)
    for k in ("input_lo", "input_hi"):
        if not isinstance(entry[k], (int, float)) or isinstance(
            entry[k], bool
        ):
            _fail(f"program manifest {where}.{k} must be a number")
    if not isinstance(entry["precision"], str):
        _fail(f"program manifest {where}.precision must be a string")
    if not _is_int(entry["cell_bits"]):
        _fail(f"program manifest {where}.cell_bits must be an integer")
    layers = entry["layers"]
    if not isinstance(layers, list):
        _fail(f"program manifest {where}.layers must be a list")
    for i, e in enumerate(layers):
        lwhere = f"{where}.layers[{i}]"
        if not isinstance(e, dict):
            _fail(f"program manifest {lwhere} must be an object")
        _require(e, _CERT_LAYER_KEYS, lwhere)
        mc = e.get("min_cells")
        if mc is not None and not isinstance(mc, list):
            _fail(f"program manifest {lwhere}.min_cells must be a list or "
                  "null")


def _check_bp_entry(entry: dict, directory: str, where: str) -> None:
    if not isinstance(entry, dict):
        _fail(f"program manifest {where} must be an object")
    _require(entry, ("k_in", "n_out", "block", "tile", "arrays"), where)
    arrays = entry["arrays"]
    if not isinstance(arrays, dict):
        _fail(f"program manifest {where}.arrays must be an object")
    _require(arrays, _BP_ARRAY_FIELDS, f"{where}.arrays")
    for field, fname in arrays.items():
        _require_file(fname, directory, f"{where}.arrays.{field}")


def validate_manifest(manifest: dict, directory: str) -> None:
    """Validate manifest version, keys, and payload files *before* any
    array is constructed.  Raises :class:`ProgramFormatError` on the
    first problem; returns None when the manifest is loadable."""
    directory = _resolve_directory(directory)
    version = manifest.get("format_version")
    if version not in _SUPPORTED_VERSIONS:
        _fail(f"unsupported program format version {version!r} "
              f"(supported: {_SUPPORTED_VERSIONS})", rule="M002")
    _require(manifest, ("block", "tile", "config", "convs", "fc"), "root")
    cfg = manifest["config"]
    if not isinstance(cfg, dict):
        _fail("program manifest config must be an object")
    _require(cfg, _CONFIG_KEYS, "config")
    convs = manifest["convs"]
    if not isinstance(convs, list):
        _fail("program manifest convs must be a list")
    if manifest.get("precision", "fp32") not in ("fp32", "int8"):
        _fail(f"unknown precision {manifest.get('precision')!r}")
    for i, e in enumerate(convs):
        where = f"convs[{i}]"
        if not isinstance(e, dict):
            _fail(f"program manifest {where} must be an object")
        _require(e, _CONV_KEYS, where)
        for field in ("bias", "pattern_bits"):
            _require_file(e[field], directory, f"{where}.{field}")
        _check_bp_entry(e["bp"], directory, f"{where}.bp")
        _check_mapping_entry(e.get("mapping"), f"{where}.mapping")
    fce = manifest["fc"]
    if not isinstance(fce, dict):
        _fail("program manifest fc must be an object")
    _require(fce, ("d_in", "d_out", "bias", "bp"), "fc")
    if not isinstance(fce.get("reorder", "pattern"), str):
        _fail("program manifest fc.reorder must be a string")
    _require_file(fce["bias"], directory, "fc.bias")
    _check_bp_entry(fce["bp"], directory, "fc.bp")
    part = manifest.get("partition")
    if part is not None:
        _require(part, ("data", "model", "data_axis", "model_axis"),
                 "partition")
    _check_certificate_entry(manifest.get("certificate"), "certificate")


def load_program(
    directory: str,
    verify: bool = False,
    device: str | torch.device | None = None,
) -> CompiledNetwork:
    """Load a program written by :func:`save_program` (of either package).

    The manifest's version, keys and payload files are validated before
    any array is constructed, so a corrupt or truncated program raises
    one :class:`ProgramFormatError` naming its rule.  The kernel operands
    land on ``device`` (``None`` means ``cuda`` and raises when there is
    none).

    Differs from the reference, whose default is ``verify=True``: the
    static verifier is not ported yet, so ``verify`` defaults to False
    here and ``verify=True`` raises ``NotImplementedError`` (ROADMAP
    Queue 1 item 8).
    """
    if verify:
        raise NotImplementedError(
            "load_program(verify=True): the static verifier is not ported "
            "yet (ROADMAP Queue 1 item 8)"
        )
    device = resolve_device(device)
    directory = _resolve_directory(directory)
    manifest = read_manifest(directory)
    validate_manifest(manifest, directory)
    c = manifest["config"]
    cfg = CNNConfig(
        conv_channels=tuple(tuple(x) for x in c["conv_channels"]),
        pool_after=frozenset(c["pool_after"]),
        num_classes=c["num_classes"],
        input_hw=c["input_hw"],
        kernel=c["kernel"],
    )
    try:
        convs = [
            CompiledConv(
                name=e["name"],
                c_in=e["c_in"],
                c_out=e["c_out"],
                kernel=e["kernel"],
                out_hw=e["out_hw"],
                pool_after=e["pool_after"],
                bp=_load_bp(e["bp"], directory, device),
                bias=np.load(os.path.join(directory, e["bias"])),
                pattern_bits=np.load(
                    os.path.join(directory, e["pattern_bits"])
                ),
                mapping=(
                    MappingCandidate.from_manifest(e["mapping"])
                    if e.get("mapping") is not None
                    else None
                ),
            )
            for e in manifest["convs"]
        ]
        fce = manifest["fc"]
        fc = CompiledFC(
            d_in=fce["d_in"],
            d_out=fce["d_out"],
            bp=_load_bp(fce["bp"], directory, device),
            bias=np.load(os.path.join(directory, fce["bias"])),
            reorder=str(fce.get("reorder", "pattern")),
        )
    except (OSError, ValueError) as e:
        raise ProgramFormatError(
            f"program payload under {directory} failed to load: {e}",
            rule="M005",
        ) from e
    part = manifest.get("partition")
    cert_entry = manifest.get("certificate")
    certificate = None
    if cert_entry is not None:
        try:
            certificate = RangeCertificate.from_manifest(cert_entry)
        except (KeyError, TypeError, ValueError) as e:
            raise ProgramFormatError(
                f"program manifest certificate failed to decode: {e}",
                rule="M003",
            ) from e
    return CompiledNetwork(
        config=cfg,
        convs=convs,
        fc=fc,
        block=manifest["block"],
        tile=manifest["tile"],
        partition=NetworkPartition.from_manifest(part) if part else None,
        precision=manifest.get("precision", "fp32"),
        cell_bits=int(manifest.get("cell_bits", 4)),
        certificate=certificate,
    )
