"""What a run measures, found by name.

``BENCHMARK.json`` names the cells, configurations, traffic mixes and
metrics; everything that belongs to one of them sits in a file of its
own, which this module finds by that name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a cell: ``cells/<workload name>.json`` (the shapes its ingest warms);
- a traffic mix: ``traffic/<traffic>.json``, whose ``generator`` names
  the module ``traffic/<generator>.py`` that drives it;
- a per-layer metric: ``metrics/<metric name>.py``, whose ``read(ctx)``
  returns the number or None.

Adding a cell, a configuration, a mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

#: The benchmark's folder and the checkout root above it.
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    config_name: str
    traffic: dict         # the traffic mix's parameters
    traffic_name: str
    cell: dict            # the cell file's contents
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / 'BENCHMARK.json')


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics, as
    ``BENCHMARK.json`` names them."""
    bench = benchmark(root)
    for w in bench['workloads']:
        if w['name'] == name:
            break
    else:
        raise KeyError('no workload %r in BENCHMARK.json' % (name,))
    cfg_entry = next(c for c in bench['configs']
                     if c['name'] == w['config'])
    here = root / HERE.name
    # a metric with no ``workloads`` is reported in every cell (a
    # per-layer one: in every cell that reports the metric it moves)
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (name in m['workloads'] if 'workloads' in m
                     else m['moves'] in e2e_names)]
    return Cell(name=name, chips=int(w['chips']),
                config=load_json(root / cfg_entry['file']),
                config_name=w['config'],
                traffic=load_json(here / 'traffic'
                                  / ('%s.json' % (w['traffic'],))),
                traffic_name=w['traffic'],
                cell=load_json(here / 'cells' / ('%s.json' % (name,))),
                end_to_end=e2e, per_layer=per_layer)


def generator(traffic: dict):
    """The module that drives a mix: ``traffic/<generator>.py``."""
    return importlib.import_module('%s.traffic.%s'
                                   % (HERE.name, traffic['generator']))


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (a metric name may
    hold dots, so the file is loaded by its path)."""
    path = root / HERE.name / 'metrics' / ('%s.py' % (name,))
    spec = importlib.util.spec_from_file_location(
        '%s.metrics.%s' % (HERE.name, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
