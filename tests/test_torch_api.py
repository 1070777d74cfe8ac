"""The PyTorch port's top-level names against the JAX package's: a name
that both packages export is the same function, class or module in
both, so code written for one runs on the other."""
import inspect

import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import config, convert
from filter_functions_tpu_torch.models import qft
from testutil import make_pulse, rand_pulse_arrays
from torch_testutil import QFT_NPZ, fft_cpu


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
            'infidelity', 'infidelity_derivative', 'liouville_representation',
            'basis', 'config', 'functional', 'gradient', 'numeric',
            'pulse_sequence', 'superoperator', 'types', 'util'} <= set(shared)
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
    assert fft.infidelity_derivative is fft.gradient.infidelity_derivative
    assert set(ff.gradient.__all__) == set(fft.gradient.__all__)
    assert all(hasattr(fft, name) for name in fft.__all__)


def test_cexp_cexpm1_and_basis_sparse_match_jax():
    """util.cexp and util.cexpm1 (in util.__all__) return complex128
    tensors within 1e-15 of the JAX package's, cexpm1 keeping its
    relative precision at small arguments; Basis.sparse is the dense
    host array, equal to the JAX package's."""
    x = np.concatenate([np.linspace(-7, 7, 41), [1e-12, -3e-9, 0.0]])
    for name in ('cexp', 'cexpm1'):
        assert name in fft.util.__all__
        got = getattr(fft.util, name)(x)
        want = getattr(ff.util, name)(x)
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want.re + 1j * want.im,
                                   rtol=1e-15, atol=1e-15)
    tiny = fft.util.cexpm1(torch.tensor([1e-12], dtype=torch.float64))
    np.testing.assert_allclose(tiny.real.numpy(), [-5e-25], rtol=1e-15)
    for d in (2, 3):
        got, want = fft.Basis.ggm(d).sparse, ff.Basis.ggm(d).sparse
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)


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
        got = fft.error_transfer_matrix(make_pulse(arrays, cls=fft_cpu),
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
    got = fft.infidelity(make_pulse(arrays, cls=fft_cpu), 1e-2 / omega, omega)
    want = np.asarray(ff.infidelity(make_pulse(arrays), 1e-2 / omega, omega))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


#: The entry points that build a pulse, and with it its device.
ENTRY_POINTS = (fft.PulseSequence.__init__, fft.PulseSequence.from_arrays,
                qft.qft_pulse_arrays, qft.qft_pulse_sequence,
                convert.pulse_arrays_from_numpy,
                convert.pulse_sequence_from_numpy)


def test_entry_points_default_to_the_card():
    """Each of the six entry points that build a pulse defaults to
    config.DEFAULT_DEVICE, which is 'cuda'."""
    assert config.DEFAULT_DEVICE == 'cuda'
    for fn in ENTRY_POINTS:
        default = inspect.signature(fn).parameters['device'].default
        assert default == config.DEFAULT_DEVICE, fn.__qualname__


def test_default_device_without_a_card_raises():
    """Without a CUDA card, each entry point called with its default
    device raises an error that names the device and tells the caller to
    pass device='cpu': it never returns CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default runs on it')
    X, Z = fft.util.paulis[1], fft.util.paulis[3]
    arrays = dict(zip(convert.PULSE_FIELDS, rand_pulse_arrays(
        2, 3, local_rng=np.random.default_rng(5))))
    with np.load(QFT_NPZ) as z:
        npz = dict(z)
    calls = {
        'qft_pulse_arrays': lambda: fft.qft_pulse_arrays(4),
        'PulseSequence': lambda: fft.PulseSequence(
            [[X, [1.0], 'X']], [[Z, [1.0], 'Z']], [1.0]),
        'from_arrays': lambda: fft.PulseSequence.from_arrays(**arrays),
        'qft_pulse_sequence': lambda: fft.qft_pulse_sequence(4),
        'pulse_arrays_from_numpy': lambda: convert.pulse_arrays_from_numpy(
            npz),
        'pulse_sequence_from_numpy':
            lambda: convert.pulse_sequence_from_numpy(
                {**arrays, 'basis': fft.Basis.ggm(2).np}),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError) as err:
            call()
        assert "'cuda'" in str(err.value), name
        assert "device='cpu'" in str(err.value), name
