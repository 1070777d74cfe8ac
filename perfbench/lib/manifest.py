"""What a run reads: the manifest ``BENCHMARK.json`` at the root of the
checkout, and the files of a cell, found by the names it gives.

* configuration ``<config>``: the file the manifest names (under
  ``perfbench/configs/``), its data under ``perfbench/data/``, and its
  plain reference ``perfbench/reference/<config>.py``;
* traffic mix ``<traffic>``: ``perfbench/traffic/<traffic>.json``, whose
  ``entry`` names ``perfbench/entries/<entry>.py``;
* per-layer metric ``<metric>``: ``perfbench/metrics/<metric>.py``;
* the limits of the cell's comparison: ``perfbench/limits/<cell>.json``.

A new cell, configuration, mix or metric is a new entry in the manifest
and new files; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple, Optional

import numpy as np

from perfbench.lib import traffic

PACKAGE = 'perfbench'


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / 'BENCHMARK.json').read_text())


def _reported_in(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def cell(root: Path, name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell *name* with its configuration, mix, metrics and limits."""
    root = Path(root)
    manifest = manifest or load_manifest(root)
    by_name = {w['name']: w for w in manifest['workloads']}
    if name not in by_name:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json (there are '
                       f'{sorted(by_name)})')
    workload = by_name[name]
    configs = {c['name']: c for c in manifest['configs']}
    entry = configs[workload['config']]
    config = json.loads((root / entry['file']).read_text())
    mix = traffic.load_mix(root / PACKAGE / 'traffic'
                           / f'{workload["traffic"]}.json')
    end_to_end = [m for m in manifest['end_to_end'] if _reported_in(m, name)]
    reported = {m['name'] for m in end_to_end}
    per_layer = [m for m in manifest['per_layer']
                 if _reported_in(m, name) and m['moves'] in reported]
    limits = json.loads((root / PACKAGE / 'limits' / f'{name}.json')
                        .read_text())
    return Cell(name, workload, config, mix, end_to_end, per_layer, limits)


def module(root: Path, kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` of the checkout at *root*, loaded
    by its path (a metric's name may hold dots)."""
    path = Path(root) / PACKAGE / kind / f'{name}.py'
    if not path.exists():
        raise FileNotFoundError(f'{kind} {name!r}: no file {path}')
    key = f'{PACKAGE}.{kind}.{name}'
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def omega(config: dict, root: Path) -> np.ndarray:
    """The configuration's frequencies: ``{"geomspace": [lo, hi, n]}`` or
    ``{"file": <JSON list under the checkout>}``."""
    spec = config['omega']
    if 'geomspace' in spec:
        lo, hi, n = spec['geomspace']
        return np.geomspace(lo, hi, int(n))
    return np.array(json.loads((Path(root) / spec['file']).read_text()),
                    dtype=np.float64)


def inputs(config: dict, root: Path) -> dict:
    """The inputs that the program and the reference are both given:
    the frequencies, the spectrum A / omega^p, and the configuration's
    frozen arrays where it has them."""
    w = omega(config, root)
    spec = config['spectrum']
    data = {'config': config, 'omega': w,
            'spectrum': spec['amplitude'] / w ** spec['power']}
    if 'arrays' in config:
        with np.load(Path(root) / config['arrays']) as z:
            data['arrays'] = {k: z[k] for k in z.files}
    return data


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
