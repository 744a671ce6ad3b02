"""Planning a cell from ``BENCHMARK.json`` and the files it names, and the
checks every run makes before it prints its result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

  ``BENCHMARK.json``           cells (``workloads``), configurations,
                               metrics
  ``<config file>``            one deployment (a configuration's
                               ``file``); its ``runner`` and
                               ``reference`` name modules below
  ``portbench/traffic/<mix>.json``  one traffic mix; its ``generator``
                               names a module below
  ``portbench/runners/<runner>.py``  drives the program for a cell
  ``portbench/gen/<generator>.py``   makes a mix's inputs from the seed
  ``portbench/reference/<reference>.py``  the plain reference
  ``portbench/metrics/<metric>.py``  reads one per-layer metric

so a later cell, configuration, mix or metric is new files and new
entries, and no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not hold once its window has closed:
# JAX and the JAX package (``repro``; the port, ``repro_torch``, is
# another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Plan:
    """One cell, with every file it names read and every module loaded."""
    cell: dict
    config: dict
    traffic: dict
    runner: ModuleType
    generator: ModuleType
    reference: ModuleType
    end_to_end: list
    per_layer: list            # [(metric entry, reader module)]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``<base>/<kind>/<name>.py`` as a module; a missing file raises."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries: list, name: str, what: str) -> dict:
    hits = [e for e in entries if e["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"BENCHMARK.json has {len(hits)} {what} named "
                       f"{name!r}")
    return hits[0]


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that cell ``cell`` reports: those with
    no ``workloads`` key and those that list it."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def plan(bench: dict, cell_name: str, root: Path = ROOT,
         base: Path = HERE) -> Plan:
    """Read every file cell ``cell_name`` names and load its modules."""
    cell = _named(bench["workloads"], cell_name, "cells")
    entry = _named(bench["configs"], cell["config"], "configurations")
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((base / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    reference = load_module("reference", config["reference"], base)
    reference.check_supported(config)
    return Plan(
        cell=cell, config=config, traffic=traffic,
        runner=load_module("runners", config["runner"], base),
        generator=load_module("gen", traffic["generator"], base),
        reference=reference,
        end_to_end=metrics_of(bench, "end_to_end", cell_name),
        per_layer=[(m, load_module("metrics", m["name"], base))
                   for m in metrics_of(bench, "per_layer", cell_name)])


def require_cards(n: int) -> str:
    """The card's name, or exit with a message and no result when this
    machine has no CUDA card or fewer than the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card; the benchmark never runs on "
                 "the CPU")
    if torch.cuda.device_count() < n:
        sys.exit(f"portbench: the cell asks for {n} cards, this machine "
                 f"has {torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of the loaded modules that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(names & set(FORBIDDEN))


def emit(result: dict) -> None:
    """Print the numbers compared beside their limits as the last lines
    of standard error, then the result as the last line of standard
    output, its ``checks`` key last."""
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
