"""The PyTorch port's concatenation examples against the JAX package's
(tests/test_torch_examples.py sets out how): advanced_concatenation,
periodic_driving, extending_pulses and randomized_benchmarking, on the
CPU."""
import numpy as np

import filter_functions_tpu as ff
from test_torch_examples import compare, to_np


def test_advanced_concatenation(monkeypatch, capsys, tmp_path):
    """The spin echo from cached parts: the pulse-correlation filter
    function's shape, the per-(g, g') infidelities and their total within
    1e-10 relative; cached against from scratch below 1e-10 (measured
    5.8e-12 JAX, 1.3e-12 port)."""
    def want(spy):
        infid_pc = np.asarray(spy.results('infidelity')[0]).squeeze()
        return {'correlation_shape': to_np(spy.results(
                    'get_pulse_correlation_filter_function')[0]).shape,
                'correlation_infidelities': infid_pc,
                'total_infidelity': infid_pc.sum()}

    got, _ = compare('advanced_concatenation', [], want, monkeypatch, capsys,
                     tmp_path, watch=[(ff, 'infidelity'),
                                      (ff.PulseSequence,
                                       'get_pulse_correlation_filter_'
                                       'function')],
                     diagnostics={'cached_vs_scratch': 1e-10})
    assert got['echo_cached'] and got['correlations_sum_to_total']


def test_periodic_driving(monkeypatch, capsys, tmp_path):
    """1000 repeats of the NOT pulse (``--repeats 1000``): the closed form
    against ``concatenate`` below 1e-10 (both 0.0: ``[p] * n`` takes the
    closed form in both packages)."""
    compare('periodic_driving', ['--repeats', '1000'], lambda spy: {},
            monkeypatch, capsys, tmp_path,
            diagnostics={'periodic_vs_standard': 1e-10})


def test_extending_pulses(monkeypatch, capsys, tmp_path):
    """NOT and idle extended to two qubits: the dimension and the noise
    identifiers with and without the ZZ crosstalk row exactly; extended
    against explicit below 1e-13 (measured 4.8e-15 JAX, 6.9e-15 port)."""
    def want(spy):
        two, with_zz = spy.results('extend')
        return {'d': two.d,
                'identifiers': two.n_oper_identifiers.tolist(),
                'zz_identifiers': with_zz.n_oper_identifiers.tolist()}

    got, _ = compare('extending_pulses', [], want, monkeypatch, capsys,
                     tmp_path, watch=[(ff, 'extend')],
                     diagnostics={'extended_vs_explicit': 1e-13})
    assert got['extend_cached'] and got['remap_cached']
    assert got['remap_invariant']


def test_randomized_benchmarking(monkeypatch, capsys, tmp_path):
    """Two random Clifford sequences at lengths 1 and 5 (``--lengths 1 5
    --samples 2``, ``default_rng(2024)``): mean and spread of their
    infidelities within 1e-10 relative."""
    argv = ['--lengths', '1', '5', '--samples', '2']

    def want(spy):
        infids = np.array([np.asarray(x).sum()
                           for x in spy.results('infidelity')]).reshape(2, 2)
        return {'infidelity_mean': dict(zip([1, 5], infids.mean(1))),
                'infidelity_std': dict(zip([1, 5], infids.std(1)))}

    compare('randomized_benchmarking', argv, want, monkeypatch, capsys,
            tmp_path, watch=[(ff, 'infidelity')])
