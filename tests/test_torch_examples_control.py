"""The PyTorch port's optimal-control example against the JAX package's
(tests/test_torch_examples.py sets out how), on the CPU."""
import numpy as np

import filter_functions_tpu as ff
from filter_functions_tpu import parallel as jparallel
from test_torch_examples import compare


def test_optimal_control(monkeypatch, capsys, tmp_path):
    """GRAPE on a 16-segment X rotation for 20 steps (``--steps 20``;
    the port's ``torch.optim.Adam``, the JAX package's optax Adam): the
    loss history's ends, the best candidate's index (exactly) and
    infidelity, the initial and optimized pulses' infidelities and the
    improvement within 1e-10 relative (the 20 steps' rounding: measured
    6.9e-15 on the final loss); the analytic derivative against autograd
    below 1e-12 relative (measured 2.9e-15 JAX, 9.9e-15 port)."""
    def want(spy):
        res = spy.results('optimize_pulse')[0]
        infid0, infid1 = (np.asarray(x).sum()
                          for x in spy.results('infidelity'))
        best = int(np.argmin(np.asarray(res.infidelity)))
        return {'initial_loss': float(res.history[0]),
                'final_loss': float(res.history[-1]), 'best': best,
                'best_infidelity': float(res.infidelity[best]),
                'infidelity_initial': infid0, 'infidelity_optimized': infid1,
                'improvement': infid0 / infid1}

    compare('optimal_control', ['--steps', '20'], want, monkeypatch, capsys,
            tmp_path, watch=[(jparallel, 'optimize_pulse'),
                             (ff, 'infidelity')],
            diagnostics={'gradient_rel_diff': 1e-12})
