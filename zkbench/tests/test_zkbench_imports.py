"""Nothing the benchmark loads is JAX or the JAX package (top-level
names compared whole: the port's ``zkstream_tpu_torch`` is not the JAX
package's ``zkstream_tpu``), and the reference loads nothing of the
port."""

import ast
import json
import subprocess
import sys

from zkbench.spec import HERE, ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'zkstream_tpu'}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


def _loaded(code: str) -> set:
    res = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\n'
         'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120,
        check=True)
    return set(json.loads(res.stdout.splitlines()[-1]))


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob('*.py'):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / 'reference').rglob('*.py'):
        assert 'zkstream_tpu_torch' not in _imports(path), path
    loaded = _loaded('import zkbench.reference.ycsb')
    assert not loaded & (FORBIDDEN | {'zkstream_tpu_torch', 'torch'})


def test_what_a_run_loads():
    metrics = sorted(p.stem for p in (HERE / 'metrics').glob('*.py'))
    code = ('import zkbench.run, zkbench.devtrace, zkbench.faults, '
            'zkbench.serve, zkbench.traffic.ycsb\n'
            'from zkbench import spec\n'
            'import zkstream_tpu_torch.io.ingest, '
            'zkstream_tpu_torch.server.persist, torch\n'
            'for m in %r: spec.metric_reader(m)\n' % (metrics,))
    loaded = _loaded(code)
    assert 'zkstream_tpu_torch' in loaded
    assert not loaded & FORBIDDEN
