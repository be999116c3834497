"""A later change adds a cell, a configuration, a traffic mix with a
generator of its own, and a per-layer metric as new files and entries,
and the harness finds each by its name and runs the cell, with no file
it already had changed."""

import hashlib
import json
import shutil
import subprocess
import sys

from zkbench.spec import HERE, ROOT

NEW_CONFIG = 'standalone-64'
NEW_CELL = 'ycsb-c-64'
NEW_MIX = 'ycsb-c'
NEW_METRIC = 'client.ops_settled'

GENERATOR = '''"""A mix with a generator of its own: YCSB's, read-only."""
from zkbench.traffic.ycsb import Mix as _Ycsb


class Mix(_Ycsb):
    pass
'''

METRIC = '''"""Ops the window's ingest routed, a second."""


def read(ctx):
    return ctx.ingest['frames_routed'] / ctx.window_s
'''

DRIVE = '''
import json, sys
from zkbench import spec, run
cell = spec.find_cell(%(cell)r)
gen = spec.generator(cell.traffic)
res, checks = run.run_cell(%(cell)r, 5, 1.0, 1, device='cpu',
                           sessions=8, records=10, grace_s=10)
print(json.dumps({'generator': gen.__name__, 'config': cell.config['name'],
                  'metrics': sorted(res['metrics']), 'correct': res['correct'],
                  'attempted': res['attempted']}))
'''


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / 'zkbench').rglob('*')
            if p.is_file() and '__pycache__' not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(HERE, tmp_path / 'zkbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    (tmp_path / 'zkstream_tpu_torch').symlink_to(ROOT / 'zkstream_tpu_torch')
    before = _digests(tmp_path)
    z = tmp_path / 'zkbench'
    config = json.loads((z / 'configs' / 'standalone-1024.json').read_text())
    config.update(name=NEW_CONFIG, sessions=64)
    (z / 'configs' / (NEW_CONFIG + '.json')).write_text(json.dumps(config))
    (z / 'cells' / (NEW_CELL + '.json')).write_text(json.dumps(
        {'prewarm': {'streams': [8], 'bytes': [2048]}}))
    mix = json.loads((z / 'traffic' / 'ycsb-b.json').read_text())
    mix.update(generator='ycsb_read_only', readproportion=1.0,
               updateproportion=0.0)
    (z / 'traffic' / (NEW_MIX + '.json')).write_text(json.dumps(mix))
    (z / 'traffic' / 'ycsb_read_only.py').write_text(GENERATOR)
    (z / 'metrics' / (NEW_METRIC + '.py')).write_text(METRIC)
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': NEW_CONFIG, 'source': 'test',
        'file': 'zkbench/configs/%s.json' % NEW_CONFIG, 'reduced': [],
        'why': 'test'})
    bench['workloads'].append({'name': NEW_CELL, 'config': NEW_CONFIG,
                               'traffic': NEW_MIX, 'chips': 1,
                               'why': 'test'})
    bench['per_layer'].append({
        'name': NEW_METRIC, 'unit': 'ops/s', 'better': 'higher',
        'source': 'program_counter', 'layer': 'FleetIngest',
        'moves': 'op_p99_ms', 'workloads': [NEW_CELL]})
    bench['end_to_end'][0]['workloads'].append(NEW_CELL)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    res = subprocess.run([sys.executable, '-c', DRIVE % {'cell': NEW_CELL}],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out['generator'] == 'zkbench.traffic.ycsb_read_only'
    assert out['config'] == NEW_CONFIG
    assert NEW_METRIC in out['metrics']
    assert out['correct'] and out['attempted'] > 0
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before
