"""Metric base classes and reco/interactions merge helpers.

The port's copy of ``rectools_tpu/metrics/base.py``.

Behavioral parity with reference rectools/metrics/base.py:30-160.
"""

import typing as tp
import warnings

import attr
import numpy as np
import pandas as pd

from ..columns import Columns

ExternalItemId = tp.Union[str, int]
Catalog = tp.Collection[ExternalItemId]


@attr.s(auto_attribs=True)
class MetricAtK:
    """Base class of metrics computed on the top-`k` recommendations."""

    k: int

    @classmethod
    def _check(
        cls,
        reco: pd.DataFrame,
        interactions: tp.Optional[pd.DataFrame] = None,
        prev_interactions: tp.Optional[pd.DataFrame] = None,
        ref_reco: tp.Optional[pd.DataFrame] = None,
    ) -> None:
        frames: tp.Dict[str, tp.Tuple[tp.Optional[pd.DataFrame], bool]] = {
            "reco": (reco, True),  # (frame, is_ranked)
            "interactions": (interactions, False),
            "prev_interactions": (prev_interactions, False),
            "ref_reco": (ref_reco, True),
        }
        for name, (df, ranked) in frames.items():
            needed = Columns.UserItem + ([Columns.Rank] if ranked else [])
            cls._check_columns(df, name, needed)
            if ranked:
                cls._check_rank_column(df, name)

    @staticmethod
    def _check_columns(df: tp.Optional[pd.DataFrame], name: str, required_columns: tp.Iterable[str]) -> None:
        if df is None:
            return
        missing = {col for col in required_columns if col not in df.columns}
        if missing:
            raise KeyError(f"Missed columns {missing} in '{name}' dataframe")

    @staticmethod
    def _check_rank_column(reco: tp.Optional[pd.DataFrame], df_name: str) -> None:
        if reco is None or reco.empty:
            return
        ranks = reco[Columns.Rank]
        problems = []
        if ranks.dtype.kind not in ("i", "u"):
            problems.append(f"Expected integer dtype of '{Columns.Rank}' column in '{df_name}' dataframe.")
        if int(round(ranks.min())) != 1:
            problems.append(f"Expected min value of '{Columns.Rank}' column in '{df_name}' dataframe to be equal to 1.")
        for message in problems:
            warnings.warn(message)


def merge_reco(reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.DataFrame:
    """Left-join ranks onto interactions (reference base.py:81-105)."""
    return pd.merge(
        interactions.reindex(columns=Columns.UserItem),
        reco.reindex(columns=Columns.UserItem + [Columns.Rank]),
        on=Columns.UserItem,
        how="left",
    )


def outer_merge_reco(reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.DataFrame:
    """Outer merge keeping every rank 1..max per user plus unpredicted test
    positives (null ranks); adds the "__test_positive" flag
    (reference base.py:106-160). Used by AUC metrics."""
    positives = interactions.reindex(columns=Columns.UserItem).drop_duplicates()
    positives["__test_positive"] = True
    relevant_reco = reco.loc[
        reco[Columns.User].isin(positives[Columns.User].unique()), Columns.UserItem + [Columns.Rank]
    ]
    merged = pd.merge(positives, relevant_reco, on=Columns.UserItem, how="outer")
    # dense 1..max_rank scaffold per user, built vectorized (no apply/explode):
    # user u with max rank r contributes rows (u, 1), ..., (u, r)
    per_user_max = relevant_reco.groupby(Columns.User)[Columns.Rank].max().astype(np.int64)
    counts = per_user_max.to_numpy()
    scaffold = pd.DataFrame(
        {
            Columns.User: np.repeat(per_user_max.index.to_numpy(), counts),
            Columns.Rank: (
                np.concatenate([np.arange(1, c + 1) for c in counts]) if len(counts) else np.array([], np.int64)
            ),
        }
    )
    ranked = merged.merge(scaffold, on=[Columns.User, Columns.Rank], how="outer")
    ranked = ranked.sort_values([Columns.User, Columns.Rank]).reset_index(drop=True)
    ranked["__test_positive"] = ranked["__test_positive"].fillna(False).astype(bool)
    return ranked
