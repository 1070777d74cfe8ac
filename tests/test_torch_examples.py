"""The PyTorch port's examples (``examples_torch/``) against the JAX
package's (``examples/``), on the CPU: each pair runs in process from a
``tmp_path`` working directory with the same arguments (cut only where
the example has a flag for it), the port's with ``--device cpu``.

Every number both print is compared, timings aside: the port's
``main()`` returns its numbers by name, and the JAX example's come at
full precision from the JAX package's calls it makes (recorded by a
:class:`Spy`), with the example's own arithmetic on them where it
prints a derived number.  Values agree within 1e-10 relative; the
diagnostic "max |diff|" lines each stay below the bound stated at the
test, on both sides.  The printed lines agree once their numbers are
masked (:func:`skeleton`).  No file appears under the repository, and
the port's examples import with ``jax`` and ``filter_functions_tpu``
blocked.

This file: getting_started, qft, calculating_quantum_processes and the
import guard.  tests/test_torch_examples_concat.py,
test_torch_examples_control.py and test_torch_examples_spectra.py hold
the rest, split so that each file stays well below a minute.
"""
import collections
import importlib.util
import os
import re
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import filter_functions_tpu as ff
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu import superoperator as jsuperoperator
from filter_functions_tpu import util as jutil

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ['getting_started', 'qft', 'calculating_quantum_processes',
            'advanced_concatenation', 'periodic_driving', 'extending_pulses',
            'randomized_benchmarking', 'optimal_control',
            'noise_spectroscopy', 'qutip_integration']
#: The examples that draw a figure (where matplotlib imports), under
#: their ``--out``.
FIGURES = {'qft', 'noise_spectroscopy', 'qutip_integration'}
#: Directories of the repository that .gitignore lists, or that other
#: tests write to while these run.
_IGNORED = {'.git', '__pycache__', '.hypothesis', '.pytest_cache',
            'chiprun_out', '_checkout', '_build'}


class Spy:
    """Records (args, kwargs, result) of every call of the functions it
    watches, by name, in order."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.calls = collections.defaultdict(list)

    def watch(self, owner, name: str):
        fn = getattr(owner, name)
        calls = self.calls[name]

        def spy(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((args, kwargs, out))
            return out
        self.monkeypatch.setattr(owner, name, spy)

    def results(self, name: str) -> list:
        return [out for _, _, out in self.calls[name]]


def to_np(x) -> np.ndarray:
    """numpy value of a JAX package result (C pytree or array)."""
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def repo_files() -> set:
    """Every file under the repository outside :data:`_IGNORED`."""
    found = set()
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if d not in _IGNORED]
        found.update(os.path.join(root, f) for f in files)
    return found


def skeleton(text: str) -> list:
    """The printed lines with every number, address and package name
    masked, and the lines that report a figure dropped."""
    lines = []
    for line in text.splitlines():
        if line.startswith(('wrote ', 'saved ', 'matplotlib missing')):
            continue
        line = re.sub(r'0x[0-9a-f]+', '#', line)
        line = line.replace('filter_functions_tpu_torch',
                            'filter_functions_tpu')
        lines.append(re.sub(r'[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?', '#',
                            line))
    return lines


def run_jax(name, argv, monkeypatch, capsys):
    """examples/<name>.py run as a script with *argv*, in process, with
    matplotlib blocked (the JAX examples save their figures into /tmp or
    next to themselves); returns what it printed."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setattr(sys, 'argv', [name] + list(argv))
    capsys.readouterr()
    runpy.run_path(str(REPO / 'examples' / f'{name}.py'),
                   run_name='__main__')
    return capsys.readouterr().out


def run_port(name, argv, capsys, out_dir=None):
    """``examples_torch/<name>.main(argv + ['--device', 'cpu'])`` in
    process (and ``--out out_dir`` where given); returns (its numbers,
    what it printed)."""
    spec = importlib.util.spec_from_file_location(
        f'examples_torch_{name}', REPO / 'examples_torch' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    argv = list(argv) + ['--device', 'cpu']
    if out_dir is not None:
        argv += ['--out', str(out_dir)]
    capsys.readouterr()
    values = module.main(argv)
    return values, capsys.readouterr().out


def assert_values(got, want, rtol: float = 1e-10, key: str = ''):
    """*got* equals *want*: dicts key by key, exact for booleans,
    integers, strings and shapes, within *rtol* relative for floats."""
    if isinstance(want, dict):
        assert set(got) == set(want), (key, set(got) ^ set(want))
        for k in want:
            assert_values(got[k], want[k], rtol, f'{key}/{k}')
        return
    w = np.asarray(want)
    if w.dtype.kind in 'fc':
        np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=0,
                                   err_msg=key)
    else:
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=key)


def compare(name, argv, want_fn, monkeypatch, capsys, tmp_path,
            watch=(), diagnostics=None, rtol: float = 1e-10, rtols=None):
    """Runs both examples from *tmp_path* and checks: the port's numbers
    (timings, keys ending in '_s', aside) against ``want_fn(spy)``, the
    JAX example's at full precision, within *rtol*; each diagnostic
    (key: bound) of the port's below its bound; the masked lines; and
    that no file appeared under the repository.  *rtols* gives a key its
    own tolerance.  Returns the port's numbers and the spy."""
    monkeypatch.chdir(tmp_path)
    before = repo_files()
    spy = Spy(monkeypatch)
    for owner, fn_name in watch:
        spy.watch(owner, fn_name)
    jax_out = run_jax(name, argv, monkeypatch, capsys)
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'out').mkdir(exist_ok=True)
    got, port_out = run_port(name, argv, capsys, tmp_path / 'out'
                             if name in FIGURES else None)
    assert repo_files() == before
    assert skeleton(port_out) == skeleton(jax_out), (port_out, jax_out)
    diagnostics = diagnostics or {}
    for key, bound in diagnostics.items():
        assert got[key] <= bound, (key, got[key], bound)
    want = want_fn(spy)
    # a printed boolean the JAX package's calls do not give is held by
    # the masked lines
    values = {k: v for k, v in got.items()
              if not k.endswith('_s') and k not in diagnostics
              and (k in want or not isinstance(v, bool))}
    rtols = rtols or {}
    assert_values({k: v for k, v in values.items() if k not in rtols},
                  {k: v for k, v in want.items() if k not in rtols}, rtol)
    for key, key_rtol in rtols.items():
        assert_values(values[key], want[key], key_rtol, key)
    return got, spy


def test_getting_started(monkeypatch, capsys, tmp_path):
    """The Hadamard gate: its equivalence and global phase, the DC limit
    of its filter function, the white and 1/f infidelities and the
    convergence sweep, within 1e-10 relative."""
    def want(spy):
        equal, phase = spy.results('oper_equiv')[0]
        white, one_f, (n_samples, infids) = spy.results('infidelity')
        F = to_np(spy.results('get_filter_function')[0]).real
        return {'hadamard': bool(equal), 'global_phase': float(phase),
                'dc_limit': F[0, 0, 0],
                'infidelity_white': np.asarray(white).sum(),
                'infidelity_1/f': np.asarray(one_f).sum(),
                'convergence': dict(zip(np.asarray(n_samples).tolist(),
                                        np.asarray(infids).ravel()))}

    got, _ = compare('getting_started', [], want, monkeypatch, capsys,
                     tmp_path, watch=[(jutil, 'oper_equiv'),
                                      (ff, 'infidelity'),
                                      (ff.PulseSequence,
                                       'get_filter_function')])
    assert got['hadamard']


def test_qft(monkeypatch, capsys, tmp_path):
    """The flagship on the object path at 500 frequencies: the QFT
    equivalence and its global phase, the filter function's shape and
    the total infidelity, within 1e-10 relative; ``--plot`` writes its
    figure under ``--out`` only, where matplotlib imports."""
    def want(spy):
        equal, phase = spy.results('oper_equiv')[0]
        return {'correct_action': bool(equal), 'global_phase': float(phase),
                'filter_function_shape': to_np(spy.results(
                    'get_filter_function')[0]).shape,
                'infidelity': np.asarray(spy.results('infidelity')[0]).sum()}

    got, _ = compare('qft', [], want, monkeypatch, capsys, tmp_path,
                     watch=[(jutil, 'oper_equiv'), (ff, 'infidelity'),
                            (ff.PulseSequence, 'get_filter_function')])
    assert got['correct_action']
    if importlib.util.find_spec('matplotlib') is None:
        return
    out_dir = tmp_path / 'out'
    before = repo_files()
    run_port('qft', ['--plot', '--n-qubits', '2'], capsys, out_dir)
    assert [p.name for p in out_dir.iterdir()] == ['qft_filter_function.png']
    assert repo_files() == before


def test_calculating_quantum_processes(monkeypatch, capsys, tmp_path):
    """A NOT gate under two noise channels: the shapes of the decay
    amplitudes, frequency shifts and cumulant function, the second-order
    shift of the ETM, complete positivity, and the infidelity against
    the decay amplitudes' trace, within 1e-10 relative."""
    def want(spy):
        gamma = to_np(spy.results('calculate_decay_amplitudes')[0])
        u1, u2 = (to_np(u) for u in spy.results('error_transfer_matrix'))
        return {
            'decay_amplitudes_shape': gamma.shape,
            'frequency_shifts_shape': to_np(spy.results(
                'calculate_frequency_shifts')[0]).shape,
            'cumulant_shape': to_np(spy.results(
                'calculate_cumulant_function')[0]).shape,
            'second_order_shift': np.abs(u2 - u1).max(),
            'completely_positive': bool(np.asarray(spy.results(
                'liouville_is_CP')[0])),
            'infidelity': np.asarray(spy.results('infidelity')[0]).sum(),
            'gamma_trace': gamma.trace(axis1=-2, axis2=-1).sum().real / 2}

    got, _ = compare('calculating_quantum_processes', [], want, monkeypatch,
                     capsys, tmp_path,
                     watch=[(jnumeric, 'calculate_decay_amplitudes'),
                            (jnumeric, 'calculate_frequency_shifts'),
                            (jnumeric, 'calculate_cumulant_function'),
                            (ff, 'error_transfer_matrix'),
                            (jsuperoperator, 'liouville_is_CP'),
                            (ff, 'infidelity')])
    assert got['completely_positive']
    np.testing.assert_allclose(got['gamma_trace'], got['infidelity'],
                               rtol=1e-12)


def test_examples_import_without_jax(tmp_path):
    """In a fresh interpreter whose working directory is outside the
    repository, with ``jax``, ``jaxlib`` and ``filter_functions_tpu``
    blocked in ``sys.modules``: every ``examples_torch`` module imports,
    getting_started runs on the CPU, and no module of JAX or the JAX
    package was loaded; ``--device`` defaults to 'cuda'."""
    code = textwrap.dedent(f'''
        import importlib.util, inspect, sys
        for name in ('jax', 'jaxlib', 'filter_functions_tpu'):
            sys.modules[name] = None
        modules = {{}}
        for name in {EXAMPLES!r}:
            spec = importlib.util.spec_from_file_location(
                name, {str(REPO / 'examples_torch')!r} + f'/{{name}}.py')
            modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(modules[name])
            assert '--device' in inspect.getsource(modules[name].main)
        values = modules['getting_started'].main(['--device', 'cpu'])
        assert values['hadamard'], values
        bad = [m for m in sys.modules if sys.modules[m] is not None
               and (m == 'jax' or m.startswith(('jax.', 'jaxlib',
                                                'filter_functions_tpu.')))]
        assert not bad, bad
        print('ok', len(modules))
        ''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == f'ok {len(EXAMPLES)}'
    assert "default='cuda'" in (REPO / 'examples_torch'
                                / 'getting_started.py').read_text()
