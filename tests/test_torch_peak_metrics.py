"""The port's peak metrics on hostile spectra against the JAX package, on the
CPU.

The rows of tests/peak_rows.py (a NaN sample, NaN at a dip, +-inf samples,
an all-equal row, plateaus at the borders and on top, a dip at index 0 and
at N - 1, ties in depth and in centre distance, white noise) go through the
port's ``batched_peak_metrics``, ``find_two_dips``, ``peak_parameters`` and
``spectrum_metrics`` and through the JAX package's, from the same numpy
arrays: equal NaN pattern, values within rtol 1e-6.  These pin the
semantics that the metrics kernel (``csrc/dip_qualification.cu``, its
``pigan_peak_metrics`` entry) is held to on the card, where it is compared
with ``spectrum_metrics`` on the lattice's qualification
(tests/test_torch_cuda.py).  On a row with a NaN sample the sparse-table
form, the CPU route, qualifies otherwise than the lattice, in both
packages; both routes are held here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peak_rows import ROWS, hostile_rows
from pigan_thz_torch.ops import _cuda_build
from pigan_thz_torch.ops import peaks as tp
from pigan_thz_tpu.ops import peaks as jp

torch.set_num_threads(1)

RTOL = 1e-6
N = 64
FREQ, T, C1, C2 = hostile_rows(N)
B = T.shape[0]


def _centres(kind):
    """The centres a test passes: none, each row's own, NaN in every third
    row (depth selection there), or one scalar pair for all rows."""
    if kind == "none":
        return None, None
    if kind == "per_row":
        return C1, C2
    if kind == "nan_mixed":
        c1, c2 = C1.copy(), C2.copy()
        c1[::3] = np.nan
        c2[1::3] = np.nan
        return c1, c2
    return np.float32(FREQ[N // 3]), np.float32(FREQ[2 * N // 3])


def _rows_for(c, b=B):
    """A centre as the JAX package's vmapped functions take it: (B,)."""
    return None if c is None else np.broadcast_to(np.asarray(c, np.float32), (b,))


def _assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True, err_msg=what)


def _qualified(route):
    """The qualification of the rows by one route, in each package."""
    if route == "lattice":
        return (tp.dip_qualification(torch.from_numpy(T)).qualified,
                jax.vmap(jp.dip_qualification)(jnp.asarray(T)).qualified)
    return (tp._dip_qualification_lifted(torch.from_numpy(T)).qualified,
            jax.vmap(jp._dip_qualification_lifted)(jnp.asarray(T)).qualified)


@pytest.mark.parametrize("route", ["lattice", "lifted"])
def test_the_two_routes_qualify_alike_in_both_packages(route):
    got, want = _qualified(route)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_routes_differ_only_on_rows_with_a_nan_sample():
    lat, _ = _qualified("lattice")
    lif, _ = _qualified("lifted")
    differ = {ROWS[r] for r in np.flatnonzero((lat != lif).any(1).numpy())}
    assert differ <= {"nan_sample", "nan_at_dip"}


@pytest.mark.parametrize("prominence", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("centres", ["none", "per_row", "nan_mixed", "scalar"])
def test_batched_metrics_match_jax(centres, prominence):
    c1, c2 = _centres(centres)
    got = tp.batched_peak_metrics(
        torch.from_numpy(FREQ), torch.from_numpy(T),
        *(None if c is None else torch.as_tensor(c) for c in (c1, c2)),
        min_prominence=prominence)
    want = jp.batched_peak_metrics(
        jnp.asarray(FREQ), jnp.asarray(T),
        *(None if c is None else jnp.asarray(_rows_for(c)) for c in (c1, c2)),
        min_prominence=prominence)
    assert got.shape == (B, 8) and got.dtype == torch.float32
    _assert_close(got.numpy(), want, f"{centres}, prominence {prominence}")
    assert np.isnan(got.numpy()).any() and np.isfinite(got.numpy()).any()


@pytest.mark.parametrize("route", ["lattice", "lifted"])
@pytest.mark.parametrize("centres", ["none", "per_row", "nan_mixed", "scalar"])
def test_spectrum_metrics_on_a_given_qualification_match_jax(centres, route):
    """The function the metrics kernel is held to on the card, on the
    lattice's qualification there."""
    c1, c2 = _centres(centres)
    q_t, q_j = _qualified(route)
    got = tp.spectrum_metrics(
        torch.from_numpy(FREQ), torch.from_numpy(T),
        *(None if c is None else torch.as_tensor(c) for c in (c1, c2)), qualified=q_t)
    fb = [jnp.full(B, jnp.nan) if c is None else jnp.asarray(_rows_for(c))
          for c in (c1, c2)]
    want = jax.vmap(lambda t, a, b, q: jp.spectrum_metrics(
        jnp.asarray(FREQ), t, a, b, qualified=q))(jnp.asarray(T), *fb, q_j)
    _assert_close(got.numpy(), want, f"{centres}, {route}")


@pytest.mark.parametrize("route", ["lattice", "lifted"])
@pytest.mark.parametrize("centres", ["none", "per_row", "nan_mixed"])
def test_find_two_dips_matches_jax_on_hostile_rows(centres, route):
    c1, c2 = _centres(centres)
    q_t, q_j = _qualified(route)
    if c1 is None:
        got = tp.find_two_dips(torch.from_numpy(T), qualified=q_t)
        want = jax.vmap(lambda t, q: jp.find_two_dips(t, qualified=q))(jnp.asarray(T), q_j)
    else:
        got = tp.find_two_dips(torch.from_numpy(T), freq=torch.from_numpy(FREQ),
                               centers=(torch.from_numpy(c1), torch.from_numpy(c2)),
                               qualified=q_t)
        want = jax.vmap(lambda t, a, b, q: jp.find_two_dips(
            t, freq=jnp.asarray(FREQ), centers=(a, b), qualified=q))(
            jnp.asarray(T), jnp.asarray(c1), jnp.asarray(c2), q_j)
    for name, g, w in zip(("i1", "i2", "has1", "has2"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_ties_go_to_the_lower_index():
    """Equal depths and equal centre distances: argmin's first minimum."""
    q = tp.dip_qualification(torch.from_numpy(T)).qualified
    r = ROWS.index("depth_tie")
    i1, i2, has1, has2 = tp.find_two_dips(torch.from_numpy(T[r:r + 1]), qualified=q[r:r + 1])
    assert bool(has2) and (int(i1), int(i2)) == (N // 3, 2 * N // 3)
    r = ROWS.index("distance_tie")
    mid = (N // 3 + 2 * N // 3) // 2
    i1, i2, _, has2 = tp.find_two_dips(
        torch.from_numpy(T[r:r + 1]), freq=torch.from_numpy(FREQ),
        centers=(torch.from_numpy(C1[r:r + 1]), torch.from_numpy(C2[r:r + 1])),
        qualified=q[r:r + 1])
    assert bool(has2) and (int(i1), int(i2)) == (mid - 8, mid + 8)


@pytest.mark.parametrize("where", ["dips", "borders", "random"])
def test_peak_parameters_match_jax_on_hostile_rows(where):
    rng = np.random.default_rng(7)
    idx = {"dips": np.full(B, N // 3), "borders": np.arange(B) % 2 * (N - 1),
           "random": rng.integers(0, N, B)}[where]
    want = jax.vmap(lambda t, i: jp.peak_parameters(jnp.asarray(FREQ), t, i))(
        jnp.asarray(T), jnp.asarray(idx))
    got = tp.peak_parameters(torch.from_numpy(FREQ), torch.from_numpy(T),
                             torch.from_numpy(idx))
    for name, g, w in zip(want._fields, got, want):
        if name == "valid":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            _assert_close(g.numpy(), w, name)


def test_a_cpu_tensor_reaches_no_launch(monkeypatch):
    """The metrics on the CPU are the plain versions: no entry point of the
    kernel library is called, no launch counted."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(tp, "launch", no_launch)
    monkeypatch.setattr(_cuda_build, "load_library", no_launch)
    before = _cuda_build.launch_counts()
    got = tp.batched_peak_metrics(torch.from_numpy(FREQ), torch.from_numpy(T),
                                  torch.from_numpy(C1), torch.from_numpy(C2))
    assert _cuda_build.launch_counts() == before
    q = tp._dip_qualification_lifted(torch.from_numpy(T)).qualified
    want = tp.spectrum_metrics(torch.from_numpy(FREQ), torch.from_numpy(T),
                               torch.from_numpy(C1), torch.from_numpy(C2), qualified=q)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "rank_1", "meta"])
def test_metrics_wrapper_refuses(bad):
    t = torch.zeros(4, N)
    x, err = {
        "float64": (t.double(), TypeError),
        "non_contiguous": (torch.zeros(N, 4).T, ValueError),
        "rank_1": (torch.zeros(N), ValueError),
        "meta": (torch.zeros(4, N, device="meta"), ValueError),
    }[bad]
    with pytest.raises(err):
        tp.batched_peak_metrics(torch.from_numpy(FREQ), x)
