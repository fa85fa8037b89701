"""Shared type aliases (reference: rectools/types.py)."""

import typing as tp

import numpy as np

ExternalId = tp.Union[str, int, np.integer]
ExternalIds = tp.Union[tp.Sequence[ExternalId], np.ndarray]
InternalId = int
InternalIds = tp.Union[tp.Sequence[int], np.ndarray]
InternalIdsArray = np.ndarray
AnyIds = tp.Union[ExternalIds, InternalIds]
AnySequence = tp.Union[tp.Sequence[tp.Any], np.ndarray]
