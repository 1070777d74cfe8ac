"""Nothing the benchmark runs imports JAX or the JAX package; the plain
references import nothing of the program; a run without a card prints
no result and fails."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / 'perfbench'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'filter_functions_tpu'}
PROGRAM = 'filter_functions_tpu_torch'

#: Makes importing any of FORBIDDEN fail in the subprocess.
BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in %r:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
""" % (sorted(FORBIDDEN),)


def imported_tops(path: Path):
    """Top-level names of every module that *path* imports."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def sources():
    return sorted(PACKAGE.rglob('*.py'))


def test_no_file_imports_jax_or_the_jax_package():
    assert sources()
    for path in sources():
        found = FORBIDDEN.intersection(imported_tops(path))
        assert not found, f'{path.relative_to(ROOT)} imports {found}'


def test_the_references_import_nothing_of_the_program():
    for path in sorted((PACKAGE / 'reference').rglob('*.py')):
        tops = set(imported_tops(path))
        assert PROGRAM not in tops, f'{path.relative_to(ROOT)} imports ' \
            f'the program'
        assert tops <= {'__future__', 'math', 'numpy', 'torch',
                        'perfbench'}, tops
        text = path.read_text()
        assert 'perfbench.entries' not in text


def test_parsing_and_the_manifest_load_with_jax_blocked():
    code = BLOCKER + """
sys.path.insert(0, %r)
from perfbench import run
from perfbench.lib import manifest
args = run.parse(['--workload', 'qft4.infidelity', '--seed', '3000000019',
                  '--seconds', '30', '--trace', '1'])
root = run.ROOT
for w in manifest.load_manifest(root)['workloads']:
    cell = manifest.cell(root, w['name'])
    data = manifest.inputs(cell.config, root)
    manifest.module(root, 'entries', cell.mix['entry'])
    manifest.module(root, 'reference', cell.workload['config'])
    for m in cell.per_layer:
        manifest.module(root, 'metrics', m['name'])
print('loaded', args.workload)
""" % (str(ROOT),)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert 'loaded qft4.infidelity' in out.stdout


def test_a_run_without_a_card_fails_with_no_result(tmp_path):
    pytest.importorskip('torch')
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    out = subprocess.run(
        [sys.executable, str(PACKAGE / 'run.py'), '--workload',
         'qft4.infidelity', '--seed', '3000000021', '--seconds', '1'],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 2
    assert 'CUDA' in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
