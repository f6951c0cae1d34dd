"""Finding what a cell needs by name: the cell in `BENCHMARK.json`, its
configuration `configs/<name>.json`, its traffic mix `traffic/<name>.json`,
its limits `limits/<cell>.json`, a metric's reader `metrics/<name>.py`, the
kernel-name tables `kernels/<layer>.json`, the card's peaks
`peaks.json` and a model family's adapter `families/<family>.py`. Adding
any of them adds a file and an entry; no file here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    """The cell's entry of `workloads`, with its configuration and traffic
    files read, and its metrics: `end_to_end` and `per_layer`, each those
    whose `workloads` (if given) list the cell."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "name": name,
        "chips": w["chips"],
        "config": read_json(ROOT / config["file"]),
        "traffic": traffic(w["traffic"]),
        "limits": limits(name),  # None until the cell's limits are set
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def traffic(name: str) -> dict:
    return read_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Optional[dict]:
    """{number: {"limit", ...}} of the cell's check, None where the file
    is not there."""
    path = HERE / "limits" / f"{cell_name}.json"
    return read_json(path)["numbers"] if path.exists() else None


def peaks() -> dict:
    return read_json(HERE / "peaks.json")


def kernel_tables() -> Dict[str, List[str]]:
    """{table name: kernel-name substrings} of every `kernels/*.json`."""
    return {p.stem: read_json(p)["kernels"]
            for p in sorted((HERE / "kernels").glob("*.json"))}


def family(name: str):
    return importlib.import_module(f"cardbench.families.{name}")


def metric_reader(name: str):
    """`read(run) -> value or None` of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[dict], run: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out: Dict[str, dict] = {}
    for m in entries:
        value: Optional[float] = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
