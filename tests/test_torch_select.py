"""The port's device select is decision-identical to the reference's JAX
select and to the numpy Scheduler: same blocks, same order, same
tie-breaking (descending PSD, lowest id first), UNSEEN entries and pruned
blocks included, and ``pad_id`` in every slot past the take counts.
Mirrors tests/test_engines.py::test_device_select_matches_numpy."""
import numpy as np
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import one_torch_thread  # noqa: F401

from repro.core import state as state_lib
from repro.core.schedule import Scheduler
from repro.core.schedule import make_device_select as j_select
from repro_torch.core.schedule import make_device_select as t_select


def _both(p, width, i2, it, psd, is_hot, pad_id):
    jd = j_select(width=width, cold_frac=0.25, min_psd=1e-12, pad_id=pad_id)
    td = t_select(width=width, cold_frac=0.25, min_psd=1e-12, pad_id=pad_id)
    j = [np.asarray(x) for x in jd(it, i2, psd, is_hot)]
    t = [x.numpy() for x in td(it, i2, torch.from_numpy(psd),
                               torch.from_numpy(is_hot))]
    return j, t


@given(p=st.integers(2, 40), width=st.integers(1, 12),
       i2=st.integers(0, 5), it=st.integers(0, 9), seed=st.integers(0, 50),
       pad_id=st.integers(0, 3), sub=st.booleans())
@settings(max_examples=40, deadline=None)
def test_device_select_matches_reference(p, width, i2, it, seed, pad_id,
                                         sub):
    rng = np.random.default_rng(seed)
    psd = rng.choice([0.0, 1e-13, 0.5, 0.5, 1.0, 2.0, state_lib.UNSEEN],
                     size=p).astype(np.float32)
    if sub:  # the engine's (P, 1) layout
        psd = psd[:, None]
    is_hot = rng.random(p) < 0.4
    sel = Scheduler(width=width, i2=i2, cold_frac=0.25,
                    min_psd=1e-12).select(it, psd, is_hot)
    j, t = _both(p, width, i2, it, psd, is_hot, pad_id)
    for a, b in zip(j, t):
        assert np.array_equal(a, b)
    hot_rows, hot_ok, cold_rows, cold_ok = t
    assert hot_rows.dtype == np.int32 and hot_ok.dtype == bool
    assert np.array_equal(hot_rows[hot_ok], sel.hot_ids)
    assert np.array_equal(cold_rows[cold_ok], sel.cold_ids)
    assert np.all(hot_rows[~hot_ok] == pad_id)
    assert np.all(cold_rows[~cold_ok] == pad_id)


def test_ties_break_by_lowest_id():
    psd = np.array([1.0, 2.0, 1.0, 2.0, 1.0, state_lib.UNSEEN],
                   np.float32)
    is_hot = np.array([True, True, True, False, False, False])
    j, t = _both(6, 4, 4, 1, psd, is_hot, 0)
    for a, b in zip(j, t):
        assert np.array_equal(a, b)
    hot_rows, hot_ok, cold_rows, cold_ok = t
    assert list(hot_rows[hot_ok]) == [1, 0, 2]
    assert list(cold_rows[cold_ok]) == [5]  # UNSEEN outranks every PSD
