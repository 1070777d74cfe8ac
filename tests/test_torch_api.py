"""The PyTorch port's top-level names against the JAX package's: a name
that both packages export is the same function, class or module in
both, so code written for one runs on the other."""
import inspect

import numpy as np

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from testutil import make_pulse, rand_pulse_arrays


def _port_name(name: str) -> str:
    return name.replace('filter_functions_tpu', 'filter_functions_tpu_torch',
                        1)


def test_shared_top_level_names_are_counterparts():
    """Every name of filter_functions_tpu.__all__ that the port exports
    comes from the counterpart module: fft.infidelity is
    numeric.infidelity, which takes a PulseSequence, as ff.infidelity
    does (the functional one stays fft.functional.infidelity)."""
    shared = [name for name in ff.__all__ if hasattr(fft, name)]
    assert {'Basis', 'PulseSequence', 'error_transfer_matrix',
            'infidelity', 'liouville_representation', 'basis', 'config',
            'functional', 'numeric', 'pulse_sequence', 'superoperator',
            'types', 'util'} <= set(shared)
    for name in shared:
        want, got = getattr(ff, name), getattr(fft, name)
        if inspect.ismodule(want):
            assert got.__name__ == _port_name(want.__name__), name
        else:
            assert got.__module__ == _port_name(want.__module__), name
            assert got.__qualname__ == want.__qualname__, name
    assert fft.infidelity is fft.numeric.infidelity
    assert fft.functional.infidelity is not fft.infidelity
    assert fft.error_transfer_matrix is fft.numeric.error_transfer_matrix
    assert all(hasattr(fft, name) for name in fft.__all__)


def test_functional_names_are_counterparts():
    """Every name of filter_functions_tpu.functional.__all__ is in the
    port's functional.__all__ (the ETM pair included), and each is
    defined in the port's functional module."""
    from filter_functions_tpu import functional as jfunctional
    assert set(jfunctional.__all__) <= set(fft.functional.__all__)
    for name in ('error_transfer_matrix', 'batched_error_transfer_matrix'):
        assert getattr(fft.functional, name).__module__ == \
            'filter_functions_tpu_torch.functional'
    for name in ('calculate_decay_amplitudes', 'calculate_frequency_shifts',
                 'calculate_cumulant_function',
                 'calculate_second_order_filter_function_from_scratch'):
        assert callable(getattr(fft.numeric, name)), name


def test_top_level_error_transfer_matrix_takes_a_pulse():
    """fft.error_transfer_matrix(pulse, S, omega) runs as
    ff.error_transfer_matrix does, first and second order, within 1e-13
    absolute."""
    arrays = rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(1))
    omega = np.geomspace(0.1, 10, 30)
    for second in (False, True):
        got = fft.error_transfer_matrix(make_pulse(arrays, cls=fft),
                                        1e-2 / omega, omega,
                                        second_order=second)
        want = np.asarray(ff.error_transfer_matrix(
            make_pulse(arrays), 1e-2 / omega, omega, second_order=second))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_top_level_infidelity_takes_a_pulse():
    """fft.infidelity(pulse, S, omega) runs as ff.infidelity does and
    agrees with it within 1e-13 absolute (measured 4.9e-19)."""
    arrays = rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(0))
    omega = np.geomspace(0.1, 10, 50)
    got = fft.infidelity(make_pulse(arrays, cls=fft), 1e-2 / omega, omega)
    want = np.asarray(ff.infidelity(make_pulse(arrays), 1e-2 / omega, omega))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
