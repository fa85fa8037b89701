"""End to end: a SASRecModel trained by the JAX package serves the same
recommendations from the PyTorch port.

The JAX model is fitted for one epoch on a tiny seeded frame; its parameters
go to the port through ``load_jax_params`` (``device="cpu"``: the kernels'
plain twins). Item lists must be identical wherever adjacent scores differ by
more than 1e-4, and scores agree to rtol 1e-5 / atol 1e-4.
"""

import jax
import numpy as np
import pandas as pd
import pytest

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import SASRecModel

CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=12, dropout_rate=0.2)
TIE_GAP = 1e-4


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(11)
    n = 600
    return pd.DataFrame(
        {
            Columns.User: rng.integers(0, 60, n),
            Columns.Item: rng.zipf(1.3, n) % 80,
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 20000, n), unit="m"),
        }
    )


@pytest.fixture(scope="module")
def models():
    df = _frame()
    jax_ds = JaxDataset.construct(df)
    jax_model = JaxSASRecModel(**CONFIG, epochs=1, batch_size=32, seed=3).fit(jax_ds)
    params = jax.tree.map(np.asarray, jax_model.training_module.params)
    port_ds = Dataset.construct(df)
    # a small serving batch so the loop dispatches several batches before its one fetch
    port_model = SASRecModel(**CONFIG, recommend_batch_size=16, device="cpu").load_jax_params(port_ds, params)
    return df, jax_model, jax_ds, port_model, port_ds


def _assert_reco_close(got: pd.DataFrame, expected: pd.DataFrame, target_col: str) -> None:
    assert list(got.columns) == list(expected.columns)
    np.testing.assert_array_equal(got[target_col].to_numpy(), expected[target_col].to_numpy())
    np.testing.assert_array_equal(got[Columns.Rank].to_numpy(), expected[Columns.Rank].to_numpy())
    np.testing.assert_allclose(
        got[Columns.Score].to_numpy(), expected[Columns.Score].to_numpy(), rtol=1e-5, atol=1e-4
    )
    n_compared = 0
    for _, rows in expected.groupby(target_col, sort=False):
        scores = rows[Columns.Score].to_numpy()
        gap = np.abs(np.diff(scores))
        separated = np.ones(len(scores), bool)
        separated[1:] &= gap > TIE_GAP
        separated[:-1] &= gap > TIE_GAP
        pos = rows.index.to_numpy()[separated]
        np.testing.assert_array_equal(got.loc[pos, Columns.Item].to_numpy(), expected.loc[pos, Columns.Item].to_numpy())
        n_compared += len(pos)
    assert n_compared > 0.8 * len(expected)


def test_recommend_u2i_filter_viewed_matches_jax(models) -> None:
    df, jax_model, jax_ds, port_model, port_ds = models
    users = np.unique(df[Columns.User])
    expected = jax_model.recommend(users, jax_ds, k=5, filter_viewed=True)
    got = port_model.recommend(users, port_ds, k=5, filter_viewed=True)
    assert len(got) == 5 * len(users)
    _assert_reco_close(got, expected, Columns.User)
    seen = set(zip(df[Columns.User], df[Columns.Item]))
    assert not any(pair in seen for pair in zip(got[Columns.User], got[Columns.Item]))


def test_recommend_with_whitelist_matches_jax(models) -> None:
    df, jax_model, jax_ds, port_model, port_ds = models
    users = np.unique(df[Columns.User])[::3]
    whitelist = np.unique(df[Columns.Item])[::2]
    expected = jax_model.recommend(users, jax_ds, k=4, filter_viewed=False, items_to_recommend=whitelist)
    got = port_model.recommend(users, port_ds, k=4, filter_viewed=False, items_to_recommend=whitelist)
    assert set(got[Columns.Item]) <= set(whitelist)
    _assert_reco_close(got, expected, Columns.User)


def test_recommend_to_items_matches_jax(models) -> None:
    df, jax_model, jax_ds, port_model, port_ds = models
    targets = np.unique(df[Columns.Item])[:20]
    expected = jax_model.recommend_to_items(targets, jax_ds, k=5)
    got = port_model.recommend_to_items(targets, port_ds, k=5)
    assert not (got[Columns.TargetItem] == got[Columns.Item]).any()
    _assert_reco_close(got, expected, Columns.TargetItem)


def test_fit_is_not_ported_yet() -> None:
    df = _frame()
    with pytest.raises(NotImplementedError, match="training"):
        SASRecModel(**CONFIG, device="cpu").fit(Dataset.construct(df))


@pytest.mark.parametrize("session_max_len,n_factors,n_heads", [(100, 128, 4), (200, 256, 8), (1000, 64, 2)])
def test_recommend_batch_size_matches_jax(session_max_len: int, n_factors: int, n_heads: int) -> None:
    kwargs = dict(session_max_len=session_max_len, n_factors=n_factors, n_heads=n_heads)
    port = SASRecModel(**kwargs, device="cpu")._effective_recommend_batch_size()
    assert port == JaxSASRecModel(**kwargs)._effective_recommend_batch_size()
    if (session_max_len, n_factors) == (100, 128):
        assert port == 4096  # the KION serving batch
