"""Partial ROC-AUC ranking metrics: ``PartialAUC`` and ``PAP``.

The port's copy of ``rectools_tpu/metrics/auc.py``.

Capability parity with reference ``rectools/metrics/auc.py`` (PartialAUC at
:271, PAP at :382, family dispatcher at :503), derived independently from the
metric definitions in arXiv 2001.10495 / PMLR v119 hiranandani20a.

Derivation used here (hit-centric, not the reference's enriched-table
pipeline): for one user, a *hit* is a test positive that appears in the
recommendation list. A hit ranked above ``r`` of the user's negatives-in-list
("misses") is concordant with the ``k - r`` top-``k`` misses ranked below it,
so it contributes ``max(0, k - r)`` of the ``k * n_pos`` (PartialAUC) or
``k * min(n_pos, k)`` (PAP) possible pairs. Positives absent from the list
contribute nothing. This collapses the metric to three per-hit quantities —
owning user, misses ranked above, and the hit's ordinal among the user's hits
— which are computed once with flat numpy segment ops (prefix sums reset at
user boundaries + ``reduceat``) and reused by every metric/k combination.
"""

import typing as tp
from enum import Enum

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from .base import outer_merge_reco
from .debias import DebiasableMetrikAtK, calc_debiased_fit_task, debias_interactions


class InsufficientHandling(str, Enum):
    """What to do with users whose recommendation lists are too short."""

    IGNORE = "ignore"
    EXCLUDE = "exclude"
    RAISE = "raise"


@attr.s(auto_attribs=True)
class AUCFitted:
    """Reusable per-hit decomposition of (reco, interactions), produced by
    :meth:`_AUCMetric.fit` and consumed by every AUC-family metric.

    Unlike the reference container (which carries the full outer-merged table
    with cumulative helper columns), this holds only what the pair-counting
    formula needs:

    hits : pd.DataFrame
        One row per *ranked test positive* across all users, in (user, rank)
        order. Columns: ``Columns.User``; ``misses_above`` — how many of that
        user's in-list negatives rank better than the hit; ``hit_ordinal`` —
        1-based position of the hit among the user's ranked hits.
    n_pos : pd.Series
        Per-user count of distinct test positives (ranked or not), indexed by
        user id in ascending order.
    short_list_misses : pd.Series
        For each user who has at least one *unranked* test positive, the total
        number of in-list negatives. These are the only users that can be
        "insufficient" for any ``k``; the per-metric threshold is applied at
        calc time.
    """

    hits: pd.DataFrame
    n_pos: pd.Series
    short_list_misses: pd.Series


def _segment_prefix_stats(
    users: np.ndarray, ranked: np.ndarray, positive: np.ndarray
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-row (misses_above, hit_ordinal) plus segment starts and lengths.

    ``users`` must arrive grouped with each user's rows rank-ascending and
    unranked rows last — exactly the layout ``outer_merge_reco`` emits. Prefix
    sums are taken globally and re-based at each user boundary, avoiding any
    per-user Python loop.
    """
    n = len(users)
    if n == 0:
        empty = np.array([], dtype=np.int64)
        return empty, empty, empty, empty
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.not_equal(users[1:], users[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    lengths = np.diff(np.append(starts, n))

    miss = ranked & ~positive
    miss_run = np.cumsum(miss)
    carried = np.repeat(np.concatenate(([0], miss_run[starts[1:] - 1])), lengths)
    # exclusive within-user prefix: misses strictly above this row
    misses_above = miss_run - miss - carried

    hit = ranked & positive
    hit_run = np.cumsum(hit)
    hit_carried = np.repeat(np.concatenate(([0], hit_run[starts[1:] - 1])), lengths)
    hit_ordinal = hit_run - hit_carried  # inclusive: 1-based at hit rows

    return misses_above, hit_ordinal, starts, lengths


@attr.s
class _AUCMetric(DebiasableMetrikAtK):
    """Shared machinery for partial-AUC metrics (cf. reference auc.py:62)."""

    insufficient_handling: str = attr.ib(default=InsufficientHandling.IGNORE.value)

    @insufficient_handling.validator
    def _check_insufficient_handling(self, attribute: tp.Any, value: str) -> None:
        allowed = {item.value for item in InsufficientHandling.__members__.values()}
        if value not in allowed:
            raise ValueError(f"`insufficient_handling` must be one of the {allowed}. Got {value}.")

    @classmethod
    def fit(
        cls, reco: pd.DataFrame, interactions: pd.DataFrame, k_max: int, insufficient_handling_needed: bool
    ) -> AUCFitted:
        """Decompose (reco, interactions) into the per-hit statistics every
        AUC metric variant consumes. Fit once, evaluate at many ``k``."""
        cls._check(reco, interactions=interactions)
        table = outer_merge_reco(reco, interactions)

        users = table[Columns.User].to_numpy()
        ranked = table[Columns.Rank].notna().to_numpy()
        positive = table["__test_positive"].to_numpy()

        misses_above, hit_ordinal, starts, _ = _segment_prefix_stats(users, ranked, positive)
        if len(users) == 0:
            empty_hits = pd.DataFrame({Columns.User: [], "misses_above": [], "hit_ordinal": []})
            empty = pd.Series([], dtype=float).rename_axis(Columns.User)
            return AUCFitted(empty_hits, empty, empty)

        user_index = pd.Index(users[starts], name=Columns.User)
        n_pos = pd.Series(np.add.reduceat(positive, starts), index=user_index)

        hit_rows = np.flatnonzero(ranked & positive)
        hits = pd.DataFrame(
            {
                Columns.User: users[hit_rows],
                "misses_above": misses_above[hit_rows],
                "hit_ordinal": hit_ordinal[hit_rows],
            }
        )

        # Sufficiency only ever matters for users with an unranked positive
        # (a false negative): everyone else has their whole test set in-list,
        # which satisfies any k. Per-metric k filtering happens at calc time,
        # so k_max is not needed here beyond the reference-compatible signature.
        if insufficient_handling_needed:
            n_miss = np.add.reduceat(ranked & ~positive, starts)
            unseen_pos = np.add.reduceat(positive & ~ranked, starts) > 0
            short_list_misses = pd.Series(n_miss[unseen_pos], index=user_index[unseen_pos], dtype=float)
        else:
            short_list_misses = pd.Series([], dtype=float).rename_axis(Columns.User)

        return AUCFitted(hits, n_pos, short_list_misses)

    def _sufficiency_advice(self) -> str:
        raise NotImplementedError()

    def _flag_short_lists(self, fitted: AUCFitted) -> np.ndarray:
        """Users whose lists are too short for this metric's ``k``; raises if
        the policy demands it, returns the user ids to exclude otherwise."""
        if self.insufficient_handling == InsufficientHandling.IGNORE:
            return np.array([], dtype=fitted.n_pos.index.dtype if len(fitted.n_pos) else np.int64)
        flagged = fitted.short_list_misses.index[fitted.short_list_misses < self.k].to_numpy()
        if len(flagged) == 0 or self.insufficient_handling == InsufficientHandling.EXCLUDE:
            return flagged
        raise ValueError(
            f"{self.__class__.__name__}@{self.k}: {len(flagged)} user(s) have fewer than "
            f"{self.k} negatives in their recommendation lists while some of their test "
            f"positives were never recommended, so the top-{self.k} negative set is not "
            f"fully determined. {self._sufficiency_advice()} "
            f'Pass insufficient_handling="{InsufficientHandling.IGNORE.value}" to score them '
            f'pessimistically or "{InsufficientHandling.EXCLUDE.value}" to drop them.'
        )

    def _pair_fraction(self, hits: pd.DataFrame, denominator: pd.Series, keep: np.ndarray) -> pd.Series:
        """Sum per-hit concordant-pair gains over users and normalize.

        ``keep`` selects the hit rows that participate for this metric's
        ``k``; each kept hit beats ``k - misses_above`` of the top-k misses.
        Users with no kept hits score 0 (every possible pair discordant).
        """
        owner_ids = denominator.index.to_numpy()
        gains = np.zeros(len(owner_ids), dtype=np.float64)
        kept = hits[keep]
        if len(kept):
            slot = np.searchsorted(owner_ids, kept[Columns.User].to_numpy())
            np.add.at(gains, slot, (self.k - kept["misses_above"].to_numpy()).astype(np.float64))
        return pd.Series(gains / denominator.to_numpy(), index=denominator.index)

    def calc(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, interactions).mean()

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values (index: user id, ascending)."""
        is_debiased = False
        if self.debias_config is not None:
            interactions = debias_interactions(interactions, self.debias_config)
            is_debiased = True
        self._check(reco, interactions=interactions)
        needs_sufficiency = self.insufficient_handling != InsufficientHandling.IGNORE
        fitted = self.fit(reco, interactions, self.k, needs_sufficiency)
        return self.calc_per_user_from_fitted(fitted, is_debiased)

    def calc_from_fitted(self, fitted: AUCFitted, is_debiased: bool = False) -> float:
        """Mean metric value from pre-fitted statistics."""
        return self.calc_per_user_from_fitted(fitted, is_debiased).mean()

    def calc_per_user_from_fitted(self, fitted: AUCFitted, is_debiased: bool = False) -> pd.Series:
        """Per-user metric values from pre-fitted statistics."""
        raise NotImplementedError()


@attr.s
class PartialAUC(_AUCMetric):
    """AUC between all test positives and the user's top-``k`` in-list
    negatives (cf. reference auc.py:271-380; arXiv 2001.10495).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 2, 3, 3],
    ...     Columns.Item: [1, 2, 3, 1, 2, 3, 2],
    ...     Columns.Rank: [1, 2, 1, 2, 3, 1, 2]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 3, 3],
    ...     Columns.Item: [1, 2, 1, 3, 1, 2]})
    >>> PartialAUC(k=3).calc_per_user(reco, interactions).values
    array([1.        , 1.        , 0.33333333])
    >>> PartialAUC(k=3, insufficient_handling="exclude").calc_per_user(reco, interactions).values
    array([1., 1.])
    """

    def _sufficiency_advice(self) -> str:
        return f"Recommending `n_user_positives` + {self.k} items per user always suffices."

    def calc_per_user_from_fitted(self, fitted: AUCFitted, is_debiased: bool = False) -> pd.Series:
        """Per-user pAUC@k. Denominator: k * n_pos; every ranked hit above at
        least one top-k miss contributes."""
        self._check_debias(is_debiased, obj_name="AUCFitted")
        dropped = self._flag_short_lists(fitted)
        hits, n_pos = fitted.hits, fitted.n_pos
        if len(dropped):
            hits = hits[~hits[Columns.User].isin(dropped)]
            n_pos = n_pos[~n_pos.index.isin(dropped)]
        keep = (hits["misses_above"] < self.k).to_numpy()
        return self._pair_fraction(hits, n_pos * self.k, keep)


@attr.s
class PAP(_AUCMetric):
    """pAp@k — AUC between the top-``min(k, n_pos)`` ranked positives and the
    top-``k`` in-list negatives; behaves like precision@k for positive-rich
    users and like pAUC otherwise (cf. reference auc.py:382-497).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 2, 3, 3],
    ...     Columns.Item: [1, 2, 3, 1, 2, 3, 2],
    ...     Columns.Rank: [1, 2, 1, 2, 3, 1, 2]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 3, 3],
    ...     Columns.Item: [1, 2, 1, 3, 1, 2]})
    >>> PAP(k=3).calc_per_user(reco, interactions).values
    array([1.        , 1.        , 0.33333333])
    """

    def _sufficiency_advice(self) -> str:
        return f"Recommending 2 * {self.k} items per user always suffices."

    def calc_per_user_from_fitted(self, fitted: AUCFitted, is_debiased: bool = False) -> pd.Series:
        """Per-user pAp@k. Denominator: k * min(n_pos, k); only a user's first
        k ranked hits count."""
        self._check_debias(is_debiased, obj_name="AUCFitted")
        dropped = self._flag_short_lists(fitted)
        hits, n_pos = fitted.hits, fitted.n_pos
        if len(dropped):
            hits = hits[~hits[Columns.User].isin(dropped)]
            n_pos = n_pos[~n_pos.index.isin(dropped)]
        keep = ((hits["misses_above"] < self.k) & (hits["hit_ordinal"] <= self.k)).to_numpy()
        return self._pair_fraction(hits, n_pos.clip(upper=self.k) * self.k, keep)


AucMetric = tp.Union[PartialAUC, PAP]


def calc_auc_metrics(
    metrics: tp.Dict[str, AucMetric],
    reco: pd.DataFrame,
    interactions: pd.DataFrame,
) -> tp.Dict[str, float]:
    """Evaluate a batch of AUC-family metrics, fitting the per-hit
    decomposition once per distinct debias config (cf. reference auc.py:503).
    """
    needs_sufficiency = any(m.insufficient_handling != InsufficientHandling.IGNORE for m in metrics.values())
    shared_fits = {
        config: _AUCMetric.fit(reco, variant_interactions, k_max, needs_sufficiency)
        for config, (k_max, variant_interactions) in calc_debiased_fit_task(metrics.values(), interactions).items()
    }
    return {
        name: metric.calc_from_fitted(shared_fits[metric.debias_config], is_debiased=True)
        for name, metric in metrics.items()
    }
