"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic and the metrics each cell reports.  The files belong to one
thing each:

- ``bench/configs/<config>.json``: the configuration as run (its ``port``
  group builds the program's ``LMConfig``), its source and what was
  changed from it;
- ``bench/traffic/<traffic>.json``: the traffic mix's parameters, read by
  the one generator in ``traffic.py``;
- ``bench/workloads/<cell>.json``: the cell's own settings: how many
  batches its check compares, how many its traced run traces, and the
  limit of each number compared;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    settings: dict        # the cell's own file
    end_to_end: tuple     # BENCHMARK.json's end-to-end entries of this cell
    per_layer: tuple      # and its per-layer entries


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; raises KeyError
    for a cell the benchmark does not name."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = load_traffic(w["traffic"], root)
    settings = json.loads((root / "bench" / "workloads"
                           / f"{name}.json").read_text())
    return Cell(name, config, traffic, settings,
                tuple(m for m in bench["end_to_end"] if _reports(m, name)),
                tuple(m for m in bench["per_layer"] if _reports(m, name)))


def load_traffic(name: str, root: Path = ROOT) -> dict:
    """The parameters of the traffic mix ``name``."""
    return json.loads((root / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def metric_reader(name: str, root: Path = ROOT):
    """The module of ``bench/metrics/<name>.py`` (names may hold dots, so
    it is loaded from its path)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_config(config: dict):
    """The program's ``LMConfig`` from a configuration file's ``port``
    group, served in its ``dtype`` with the flash-attention kernel."""
    import torch
    from repro_torch.models.transformer import LMConfig

    port = dict(config["port"])
    dtype = getattr(torch, port.pop("dtype"))
    port["pattern"] = tuple(port["pattern"])
    return LMConfig(name=config["name"], param_dtype=dtype,
                    compute_dtype=dtype, use_flash_kernel=True, **port)
