"""The port's plain DHD versions vs the JAX package on tie-heavy inputs.

``chip_smoke.py`` holds the CUDA DHD kernels to the port's plain versions
(``ref.dhd_ell_count_ref``, ``ref.dhd_ell_ref_batch``, ``ref.dhd_ell_ref``,
and ``ops.dhd_step`` on the CPU).  Here those plain versions meet the JAX
package's Pallas kernels (interpret mode, as its own tests run them) and
``repro.kernels.ref`` on the inputs where the kernels branch: heat on 4
levels, so ``h_u == h_c`` is frequent and the strict ``>`` of both masks
decides; rows of pad slots only; a ``kmax`` that is not a multiple of 4;
B in {1, 5, 7} with shared and per-field ``vals``; and the single-field
form.  Counts are exact; flows within atol 1e-5 / rtol 1e-4, the DHD
tolerance of ``tests/test_kernels.py`` (the summation order differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels import ref as jref
from repro.kernels.dhd_spmv import _count_kernel_batch, _pad_rows
from repro.kernels.dhd_spmv import dhd_ell_step as jax_dhd_single_kernel
from repro.kernels.dhd_spmv import dhd_ell_step_batch as jax_dhd_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.dhd_spmv import dhd_ell_step, dhd_ell_step_batch

DHD_TOL = dict(atol=1e-5, rtol=1e-4)
N, KMAX, BLOCK_N = 45, 37, 16  # neither n nor kmax a multiple of 4 or of the block
PAD_EVERY = 7  # rows 0, 7, 14, ... hold pad slots only
CASES = [(B, per_field) for B in (1, 5, 7) for per_field in (False, True)]


def _tie_problem(B, per_field, seed, n=N, kmax=KMAX):
    """Heat on 4 levels, about 45% pad slots (weight 0, column = the row),
    every ``PAD_EVERY``-th row pad slots only; per-field ``vals`` switch
    further edges off field by field."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n, dtype=np.int32)[:, None]
    pad = rng.random((n, kmax)) < 0.45
    pad[::PAD_EVERY] = True
    cols = np.where(pad, rows, rng.integers(0, n, (n, kmax))).astype(np.int32)
    shape = (B, n, kmax) if per_field else (n, kmax)
    vals = (rng.random(shape) + 0.05) * ~pad
    if per_field:
        vals = vals * (rng.random(shape) < 0.8)
    heat = np.floor(rng.random((B, n)) * 4) / 4
    q = rng.random((B, n)) * 0.1
    return (heat.astype(np.float32), cols, vals.astype(np.float32), q.astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy_count(heat, cols, vals):
    """|N_u^out| straight from the definition: active slots whose
    neighbour is strictly colder."""
    live = (vals if vals.ndim == 3 else vals[None]) > 0
    return (live & (heat[:, :, None] > heat[:, cols])).sum(-1).astype(np.float32)


def _pallas_count(heat, cols, vals):
    """The JAX package's batched count kernel alone, in interpret mode, with
    the grid and blocks of its wrapper ``dhd_ell_step_batch``."""
    B, n = heat.shape
    h, c, v, _ = _pad_rows(jnp.asarray(heat), jnp.asarray(cols), jnp.asarray(vals), BLOCK_N)
    n_pad, kmax = c.shape
    if v.ndim == 3:
        vals_spec = pl.BlockSpec((1, BLOCK_N, kmax), lambda bb, i: (bb, i, 0))
    else:
        vals_spec = pl.BlockSpec((BLOCK_N, kmax), lambda bb, i: (i, 0))
    out = pl.pallas_call(
        _count_kernel_batch,
        grid=(B, n_pad // BLOCK_N),
        in_specs=[
            pl.BlockSpec((1, n_pad), lambda bb, i: (bb, 0)),
            pl.BlockSpec((BLOCK_N, kmax), lambda bb, i: (i, 0)),
            vals_spec,
        ],
        out_specs=pl.BlockSpec((1, BLOCK_N), lambda bb, i: (bb, i)),
        out_shape=jnp.zeros((B, n_pad), jnp.float32),
        interpret=True,
    )(h, c, v)
    return np.asarray(out)[:, :n]


def _ties(heat, cols, vals):
    """Live slots whose neighbour has exactly the row's heat."""
    live = (vals if vals.ndim == 3 else vals[None]) > 0
    return int((live & (heat[:, :, None] == heat[:, cols])).sum())


@pytest.mark.parametrize("B,per_field", CASES)
def test_count_exact_on_ties(B, per_field):
    heat, cols, vals, _ = _tie_problem(B, per_field, seed=B)
    assert _ties(heat, cols, vals) > 0
    got = tref.dhd_ell_count_ref(_t(heat), _t(cols), _t(vals)).numpy()
    np.testing.assert_array_equal(got, _numpy_count(heat, cols, vals))
    np.testing.assert_array_equal(got, _pallas_count(heat, cols, vals))
    assert not got[:, ::PAD_EVERY].any()  # pad rows have no colder neighbour


@pytest.mark.parametrize("B,per_field", CASES)
def test_flow_matches_jax_on_ties(B, per_field):
    heat, cols, vals, q = _tie_problem(B, per_field, seed=10 + B)
    th, tc, tv, tq = _t(heat), _t(cols), _t(vals), _t(q)
    got = tref.dhd_ell_ref_batch(th, tc, tv, tq).numpy()
    want_ref = jref.dhd_ell_ref_batch(*map(jnp.asarray, (heat, cols, vals, q)))
    want_kernel = jax_dhd_kernel(*map(jnp.asarray, (heat, cols, vals, q)),
                                 block_n=BLOCK_N, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_ref), **DHD_TOL)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **DHD_TOL)
    # the two passes as chip_smoke.py checks them, and the wrapper on the CPU
    flow = tref.dhd_ell_flow_ref(th, tref.dhd_ell_count_ref(th, tc, tv), tc, tv, tq).numpy()
    np.testing.assert_array_equal(flow, got)
    np.testing.assert_array_equal(dhd_ell_step_batch(th, tc, tv, tq).numpy(), got)
    # a row of pad slots only exchanges no heat: its epilogue alone
    pad = slice(None, None, PAD_EVERY)
    np.testing.assert_allclose(got[:, pad], 0.9 * heat[:, pad] + 0.3 * q[:, pad], **DHD_TOL)


@pytest.mark.parametrize("kmax", [KMAX, 13, 80])
def test_single_field_matches_jax_on_ties(kmax):
    heat, cols, vals, q = _tie_problem(1, False, seed=20 + kmax, kmax=kmax)
    h, qq = heat[0], q[0]
    assert _ties(heat, cols, vals) > 0
    th, tc, tv, tq = _t(h), _t(cols), _t(vals), _t(qq)
    got = tref.dhd_ell_ref(th, tc, tv, tq).numpy()
    want_ref = jref.dhd_ell_ref(*map(jnp.asarray, (h, cols, vals, qq)))
    want_kernel = jax_dhd_single_kernel(*map(jnp.asarray, (h, cols, vals, qq)),
                                        block_n=BLOCK_N, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_ref), **DHD_TOL)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **DHD_TOL)
    np.testing.assert_array_equal(
        tref.dhd_ell_count_ref(th[None], tc, tv)[0].numpy(), _numpy_count(heat, cols, vals)[0]
    )
    for out in (dhd_ell_step(th, tc, tv, tq), ops.dhd_step(th, tc, tv, tq),
                ops.dhd_step(th, tc, tv, tq, use_kernel=False)):
        np.testing.assert_array_equal(out.numpy(), got)
