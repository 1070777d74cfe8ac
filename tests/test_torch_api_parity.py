"""The port's API against the JAX package's, module by module: every
module of filter_functions_tpu has its counterpart in
filter_functions_tpu_torch with the same public names (``__all__`` and
the public functions and classes the module defines), and every function
and method there takes at least the JAX package's keyword parameters.

What the port leaves out on purpose is listed below with its reason
(ROADMAP.md, "What the port leaves out" and §2.3); what is still to port
is listed apart, and nothing is.  Both lists must stay exact: an entry
that the port has after all fails the test.  The JAX package's
``FF_TPU_*`` settings are held the same way: each has its counterpart
in the port or its reason.

A keyword may keep its name with a torch meaning: ``parallel.
optimize_pulse``'s ``optimizer`` is a callable ``params ->
torch.optim.Optimizer`` where the JAX package takes an optax
transformation, and ``mesh`` is a ``torch.distributed`` DeviceMesh.
"""
import importlib
import inspect
import pkgutil
import re
from pathlib import Path

import pytest

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft

#: Modules (relative to the package) the port leaves out, with reasons.
OMITTED_MODULES = {
    'cplx': 'split (re, im) complex arithmetic for a backend without '
            'complex128; the port computes in torch.complex128',
    'ops.dword_pallas': 'the Pallas kernel; the port has its CUDA kernel '
                        'in ops.dword and csrc/dword_digits.cu',
}
#: Modules still to port.
TO_PORT_MODULES = set()
#: Public names a ported module leaves out, with reasons.
OMITTED_NAMES = {
    '': {'cplx': OMITTED_MODULES['cplx']},
    'config': {name: 'a setting of the TPU backend (precision emulation, '
                     'host offload, compile cache) with no meaning on a GPU'
               for name in ('backend', 'complex_dtype', 'device_memory_bytes',
                            'eigh_mode', 'enable_host_cpu', 'eps',
                            'float_dtype', 'host_device', 'on_host',
                            'ozaki_escalation_tol', 'ozaki_factored',
                            'ozaki_operand_dtype', 'supports_native_complex',
                            'transform_dtype', 'transform_mxu')},
    'ops.ozaki': {
        'ozaki_matmul': 'float64 emulation; the port uses torch.matmul',
        'ozaki_matmul_c': 'complex128 emulation; the port uses '
                          'torch.matmul',
        'DEFAULT_PRECISION_BITS': 'config.PRECISION_BITS in the port'},
    'types': {'Qobj': 'the port\'s types are structural and name no '
                      'optional dependency'},
}
#: Keyword parameters of the JAX package a ported function leaves out.
OMITTED_PARAMETERS = {
    ('config', 'memory_budget'): {
        'fraction': 'the JAX package reads its budget from FF_TPU_* '
                    'settings; the port takes budget_bytes',
        'fallback': 'as fraction'},
    ('functional', 'control_matrix'): {
        'escalation': 'an in-graph switch of the jitted JAX pipeline; the '
                      'port takes contract and escalation_tol'},
    ('numeric', 'calculate_control_matrix_from_scratch'): {
        'out': 'the reference\'s output buffer, unused by the JAX package'},
    ('util', 'tensor'): {
        'optimize': 'the reference\'s einsum path flag, unused by the JAX '
                    'package'},
    ('util', 'tensor_insert'): {'optimize': 'as util.tensor'},
    ('util', 'tensor_merge'): {'optimize': 'as util.tensor'},
}

#: The JAX package's FF_TPU_* settings that the port carries over, each
#: with the names of its counterparts in the port (a constant, the
#: function that resolves it, or both).
PORTED_SETTINGS = {
    'CONTRACT': ('config.contraction_mode',),
    'MEMORY_BUDGET': ('config.memory_budget',),
    'OZAKI_BITS': ('config.PRECISION_BITS',),
    'OZAKI_BITS_DEEP': ('config.DEEP_PRECISION_BITS',),
    'OZAKI_ESCALATE_TOL': ('config.ESCALATION_TOL',),
}
#: The FF_TPU_* settings the port leaves out, with reasons.
OMITTED_SETTINGS = {
    'EIGH': 'the choice of real-embedding, Ogita-Aishima or refined eigh '
            'on a backend without complex128; the port calls '
            'torch.linalg.eigh',
    'NO_COMPILE_CACHE': 'the XLA compile cache; the port compiles no '
                        'graph ahead of time',
    'NO_X64': "JAX's float32 mode; the port computes in float64 and "
              'complex128',
    'OZAKI_CMUL': 'the multiplication count of split (re, im) complex '
                  'products; the port multiplies complex128 tensors',
    'OZAKI_DWORD': "the XLA form of the digit pipeline beside the Pallas "
                   'kernel; the port has the CUDA kernel and its plain '
                   'version',
    'OZAKI_FACTORED': 'turns off the factored Ozaki operand on the TPU, '
                      'which then assembles D in emulated float64; the '
                      "port's 'native' route is the complex128 product",
    'OZAKI_MXU': 'the matrix-unit operand type (int8 or bf16) of the TPU; '
                 'the port has the int8 route',
    'OZAKI_OPERANDS': 'the dtype of the Ozaki operand P on the TPU; the '
                      'port splits P into two float32 words',
    'OZAKI_RECOMB': "the bf16 and f64 recombination variants; the port "
                    "has the double-single ('ds') recombination",
    'SO_FACTORED': 'always on: the port computes the second-order term '
                   'from the separable tables of the K2 lattice and '
                   'builds the lattice only to cache it',
    'SO_DTYPE': 'float32 second-order contractions on the TPU; the port '
                'computes the second order in complex128',
    'SO_LATTICE': 'the double-single float32 K2 lattice of the TPU; the '
                  "port's lattice is complex128",
    'TRANSFORM_DTYPE': 'float32 basis transforms on the TPU; the port '
                       'transforms in complex128',
    'TRANSFORM_MXU': 'basis transforms as Ozaki products on the TPU '
                     "matrix unit; the port's are complex128 products",
}


def _modules(pkg):
    return [''] + [m.name[len(pkg.__name__) + 1:] for m in
                   pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]


def _import(pkg, rel):
    return importlib.import_module(pkg.__name__ + ('.' + rel if rel else ''))


def _public(module):
    """``__all__`` and the public functions and classes *module*
    defines."""
    names = set(getattr(module, '__all__', ()))
    for name, value in vars(module).items():
        if (not name.startswith('_')
                and (inspect.isfunction(value) or inspect.isclass(value))
                and value.__module__ == module.__name__):
            names.add(name)
    return names


def _parameters(fn):
    try:
        return set(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


JAX_MODULES = _modules(ff)
PORT_MODULES = set(_modules(fft))


def test_module_lists_are_exact():
    """Every omitted module exists in the JAX package and not in the port,
    and nothing is left to port."""
    for rel in (*OMITTED_MODULES, *TO_PORT_MODULES):
        assert rel in JAX_MODULES and rel not in PORT_MODULES, rel
    assert TO_PORT_MODULES == set()


@pytest.mark.parametrize('rel', [m for m in JAX_MODULES
                                 if m not in OMITTED_MODULES
                                 and m not in TO_PORT_MODULES])
def test_module_names_and_parameters(rel):
    """The port's counterpart of the JAX module has its public names
    (those it leaves out are listed with reasons) and, for each shared
    function and each method of a shared class, its parameters."""
    assert rel in PORT_MODULES, f'{rel} is not ported'
    if rel == 'plotting':
        pytest.importorskip('matplotlib', reason='plotting needs matplotlib')
    jmod, pmod = _import(ff, rel), _import(fft, rel)
    omitted = OMITTED_NAMES.get(rel, {})
    missing = _public(jmod) - _public(pmod)
    assert missing == set(omitted), (missing, set(omitted))
    for name in sorted(_public(jmod) & _public(pmod)):
        want, got = getattr(jmod, name), getattr(pmod, name)
        pairs = [(name, want, got)]
        if inspect.isclass(want):
            pairs = [(f'{name}.{meth}', getattr(want, meth),
                      getattr(got, meth, None))
                     for meth, value in vars(want).items()
                     if (meth == '__init__' or not meth.startswith('_'))
                     and (callable(value) or isinstance(
                         value, (classmethod, staticmethod)))]
        for qual, w, g in pairs:
            assert g is not None, f'{rel}.{qual} is missing'
            params_w, params_g = _parameters(w), _parameters(g)
            if params_w is None or params_g is None:
                continue
            left_out = params_w - params_g
            assert left_out == set(OMITTED_PARAMETERS.get((rel, qual), ())), \
                f'{rel}.{qual} lacks {sorted(left_out)}'


def test_pulse_sequence_reexports_the_composition_functions():
    """pulse_sequence.__all__ lists what the JAX module's lists, and the
    names are the sequencing functions (a fault this test would have
    caught)."""
    from filter_functions_tpu import pulse_sequence as jps
    from filter_functions_tpu_torch import pulse_sequence, sequencing
    assert set(pulse_sequence.__all__) == set(jps.__all__)
    for name in ('concatenate', 'concatenate_periodic', 'extend', 'remap',
                 'concatenate_without_filter_function'):
        assert getattr(pulse_sequence, name) is getattr(sequencing, name)
        assert getattr(fft, name) is getattr(sequencing, name)
    assert 'spectroscopy' in fft.__all__ and hasattr(fft, 'spectroscopy')
    assert 'exchange' in fft.models.__all__


def test_settings_are_ported_or_listed():
    """Every FF_TPU_* setting the JAX package's sources read or name has
    its counterpart in the port or a reason it is left out, and both
    lists are exact: an entry for a setting the JAX package does not have
    fails, and each counterpart exists in the port."""
    found = set()
    for path in Path(ff.__file__).parent.rglob('*.py'):
        found.update(re.findall(r'FF_TPU_([A-Z0-9_]+)', path.read_text()))
    assert not set(PORTED_SETTINGS) & set(OMITTED_SETTINGS)
    assert found == set(PORTED_SETTINGS) | set(OMITTED_SETTINGS), (
        sorted(found - set(PORTED_SETTINGS) - set(OMITTED_SETTINGS)),
        sorted(set(PORTED_SETTINGS) | set(OMITTED_SETTINGS) - found))
    for names in PORTED_SETTINGS.values():
        for name in names:
            module, attr = name.rsplit('.', 1)
            assert hasattr(_import(fft, module), attr), name
