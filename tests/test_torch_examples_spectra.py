"""The PyTorch port's noise-spectroscopy and QuTiP-boundary examples
against the JAX package's (tests/test_torch_examples.py sets out how),
on the CPU; the port's figures go under ``--out``."""
import importlib.util

import numpy as np

import filter_functions_tpu as ff
from filter_functions_tpu import spectroscopy as jspectroscopy
from test_torch_examples import compare, to_np


#: The reconstruction's numbers (the nodes after 2000 FISTA steps, the
#: fit residual and the recovery error), relative: the two packages'
#: inputs differ by rounding, which A^T A's condition (1.9e10 at ridge
#: 1e-10) may amplify up to tests/test_torch_spectroscopy.py's
#: S_HAT_PARITY, 1e-5; measured 1.06e-9 (nodes), 1.7e-10 (residual),
#: 1.5e-10 (recovery).
RECONSTRUCTION_RTOL = 1e-7


def _has_matplotlib() -> bool:
    return importlib.util.find_spec('matplotlib') is not None


def test_noise_spectroscopy(monkeypatch, capsys, tmp_path):
    """The CPMG-8 family at 16 durations: the counts of pulses and nodes
    exactly; the reconstructed spectrum at the nodes (2000 FISTA steps),
    the fit residual and the interior recovery error within
    ``RECONSTRUCTION_RTOL``, from the JAX example's design matrix,
    measurements and reconstruction; the figure under ``--out``."""
    def want(spy):
        (a, measured), _, s_nodes = spy.calls['reconstruct'][0]
        a, s_nodes = to_np(a), to_np(s_nodes)
        _, nodes = spy.results('design_matrix')[0]
        s_hat = to_np(spy.results('interpolate_spectrum')[0])
        omega = np.geomspace(2e-1, 2e2, 400)
        s_model = 1e-3 / omega**0.7 + 5e-6 / (1 + (omega - 20)**2)
        interior = (omega > nodes[1]) & (omega < nodes[-2])
        return {'pulses': len(a), 'nodes': len(nodes),
                'fit_residual': np.abs((a @ s_nodes - measured)
                                       / measured).max(),
                'recovery_median_rel_err': np.median(np.abs(
                    s_hat[interior] / s_model[interior] - 1)),
                's_nodes': s_nodes}

    compare('noise_spectroscopy', [], want, monkeypatch, capsys, tmp_path,
            watch=[(jspectroscopy, 'design_matrix'),
                   (jspectroscopy, 'reconstruct'),
                   (jspectroscopy, 'interpolate_spectrum')],
            rtols=dict.fromkeys(('s_nodes', 'fit_residual',
                                 'recovery_median_rel_err'),
                                RECONSTRUCTION_RTOL))
    figures = [p.name for p in (tmp_path / 'out').iterdir()]
    assert figures == (['noise_spectroscopy.png'] if _has_matplotlib()
                       else [])


def test_qutip_integration(monkeypatch, capsys, tmp_path):
    """Qobj operators (qutip or the tests' stub) at the boundary: the
    dimension and segment count exactly, the filter functions at the
    lowest frequency and the 1/f infidelities within 1e-10 relative; the
    figure under ``--out``, not next to the example."""
    def want(spy):
        (pulse, *_), _, F = spy.calls['get_filter_function'][0]
        F = to_np(F).real
        return {'d': pulse.d, 'segments': len(pulse),
                'filter_function_at_w_min': F[np.arange(5), np.arange(5),
                                              0],
                'infidelities': np.asarray(spy.results('infidelity')[0])}

    compare('qutip_integration', [], want, monkeypatch, capsys, tmp_path,
            watch=[(ff.PulseSequence, 'get_filter_function'),
                   (ff, 'infidelity')])
    figures = [p.name for p in (tmp_path / 'out').iterdir()]
    assert figures == (['qutip_integration_ff.png'] if _has_matplotlib()
                       else [])
