"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry ``name``) is ``stbench/workloads/<name>.json``;
its configuration is the ``configs`` entry it names, whose ``file`` holds
the model, the objective and the optimizer; the configuration's ``arch`` is
``stbench/arch/<arch>.py`` (its weights, plain forward and model work); a
per-layer metric is ``stbench/metrics/<name>.py``, and a loop
``stbench/loops/<loop>.py``. The program's ``StylizeConfig`` is the
configuration's ``stylize`` mapping overlaid by the cell's, and its
``StyleTransfer`` takes the configuration's ``program`` mapping.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the ``workloads`` entry
    workload: dict  # stbench/workloads/<name>.json
    config: dict  # the configuration's file
    config_entry: dict  # the ``configs`` entry
    end_to_end: List[dict]  # metrics this cell reports with --trace 0
    per_layer: List[dict]  # metrics this cell reports with --trace 1
    arch: ModuleType  # stbench/arch/<the configuration's arch>.py

    def stylize(self) -> dict:
        """The ``StylizeConfig`` fields, the optimizer as a mapping."""
        merged = dict(self.config["stylize"])
        for k, v in self.workload.get("stylize", {}).items():
            merged[k] = {**merged[k], **v} if isinstance(v, dict) and k in merged else v
        return merged


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    manifest = load_manifest(root)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_entry = configs[entry["config"]]
    workload = json.loads((root / "stbench" / "workloads" / f"{name}.json").read_text())
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json says config {entry['config']!r}, "
                         f"its file says {workload['config']!r}")
    config = json.loads((root / config_entry["file"]).read_text())
    return Cell(name, entry, workload, config, config_entry,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)],
                load_arch(config["arch"], root))


def load_arch(name: str, root: Path = ROOT) -> ModuleType:
    """The module ``stbench/arch/<name>.py`` under ``root``: ``weights``,
    ``prepare``, ``features`` and ``work`` (``stbench/README.md``)."""
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", name):
        raise ValueError(f"architecture {name!r} is not a name")
    path = Path(root) / "stbench" / "arch" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"architecture {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"stbench_arch_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(name: str):
    """The module ``stbench/loops/<name>.py``."""
    return importlib.import_module(f"stbench.loops.{name}")


def metric_reader(name: str) -> Optional[Callable]:
    """``read(run) -> float | None`` of ``stbench/metrics/<name>.py``, or
    None where the file does not exist."""
    path = PACKAGE / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(f"stbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def stylize_config(fields: dict):
    """The program's ``StylizeConfig`` for the merged ``fields``."""
    from style_transfer_tpu_torch.api import StylizeConfig
    from style_transfer_tpu_torch.optim import OptimizerSpec

    fields = dict(fields)
    fields["optimizer"] = OptimizerSpec(**fields["optimizer"])
    for k in ("content_layers", "style_layers", "iterations"):
        if k in fields:
            fields[k] = tuple(fields[k])
    unknown = set(fields) - {f.name for f in dataclasses.fields(StylizeConfig)}
    if unknown:
        raise ValueError(f"not StylizeConfig fields: {sorted(unknown)}")
    return StylizeConfig(**fields)


def per_layer_readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"]) for m in cell.per_layer}
