"""The port's host helpers (rectools_tpu_torch/utils/indexing.py and
rectools_tpu_torch/models/utils.py) against the JAX package's on the same
inputs: equal outputs, and the same errors."""

import typing as tp

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

from rectools_tpu.models import utils as jax_model_utils
from rectools_tpu.utils import indexing as jax_indexing
from rectools_tpu_torch.models import utils as model_utils
from rectools_tpu_torch.utils import get_element_ids, get_from_series_by_index

SERIES = pd.Series(["a", "b", "c", "d"], index=[10, 20, 30, 40])


def _both(port: tp.Callable, jax: tp.Callable, *args: tp.Any, **kwargs: tp.Any) -> tp.Tuple[tp.Any, tp.Any]:
    """Both functions' results, or both errors' types."""
    out = []
    for fn in (port, jax):
        try:
            out.append(fn(*args, **kwargs))
        except (KeyError, ValueError) as error:
            out.append(type(error))
    return out[0], out[1]


def _assert_same(got: tp.Any, expected: tp.Any) -> None:
    if isinstance(expected, type):
        assert got is expected
    elif isinstance(expected, tuple):
        assert isinstance(got, tuple) and len(got) == len(expected)
        for g, e in zip(got, expected):
            _assert_same(g, e)
    else:
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize(
    "ids,kwargs",
    [
        ([30, 10], {}),
        ([30, 50], {}),  # missing, strict: KeyError
        ([30, 50, 10], {"strict": False}),
        ([30, 50, 60], {"strict": False, "return_missing": True}),
        ([30], {"strict": True, "return_missing": True}),  # ValueError
        ([], {"strict": False}),
    ],
)
def test_get_from_series_by_index_matches_jax(ids: tp.List[int], kwargs: tp.Dict[str, bool]) -> None:
    _assert_same(*_both(get_from_series_by_index, jax_indexing.get_from_series_by_index, SERIES, ids, **kwargs))


@pytest.mark.parametrize("elements", [[40, 10, 10], [], [40, 5]])
def test_get_element_ids_matches_jax(elements: tp.List[int]) -> None:
    test_elements = np.array([30, 10, 40, 20])
    _assert_same(*_both(get_element_ids, jax_indexing.get_element_ids, np.array(elements, dtype=np.int64),
                        test_elements))


def test_get_viewed_item_ids_matches_jax() -> None:
    user_items = sparse.random(6, 9, density=0.3, format="csr", random_state=2)
    for user in range(6):
        _assert_same(model_utils.get_viewed_item_ids(user_items, user),
                     jax_model_utils.get_viewed_item_ids(user_items, user))


@pytest.mark.parametrize("k", [0, 3, 50])
@pytest.mark.parametrize("lists", ["none", "blacklist", "whitelist", "both"])
@pytest.mark.parametrize("ascending", [False, True])
def test_recommend_from_scores_matches_jax(k: int, lists: str, ascending: bool) -> None:
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 5, size=20).astype(np.float32)  # ties
    kwargs = {
        "sorted_blacklist": np.array([1, 4, 7]) if lists in ("blacklist", "both") else None,
        "sorted_whitelist": np.arange(0, 20, 2) if lists in ("whitelist", "both") else None,
        "ascending": ascending,
    }
    _assert_same(model_utils.recommend_from_scores(scores, k, **kwargs),
                 jax_model_utils.recommend_from_scores(scores, k, **kwargs))
