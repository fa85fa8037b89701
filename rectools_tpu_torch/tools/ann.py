"""User-to-item / item-to-item retrieval recommenders.

Port of rectools_tpu/tools/ann.py over the port's ``TopKEngine``
(ops/topk.py). API parity with reference rectools/tools/ann.py:32-475,
substrate replaced: the nmslib HNSW C++ index (approximate, host threads)
becomes the exact top-k MIPS engine over the item-vector table on
``device`` — queries batch through one f32 product and the grouped top-k
(kernel 3, ``csrc/topk_select.cu``), so there is no index build step, no
approximation error, and pickling carries plain arrays instead of a
serialized index binary. ``approximate=True`` is kept and served exactly,
as JAX serves it off the TPU.

The cosine-similarity space (the reference's default ``space=cosinesimil``)
is the default; over-fetch (`index_top_k`) + post-filter by per-query
whitelists matches the reference's recall-under-filter behavior.
"""

import typing as tp

import numpy as np

from ..dataset import IdMap
from ..ops.topk import Distance, TopKEngine
from ..types import ExternalId, ExternalIds, InternalId, InternalIds
from ..utils.device import resolve_device

T = tp.TypeVar("T", bound="BaseAnnRecommender")


class BaseAnnRecommender:
    """Shared query/truncate logic for the two recommenders."""

    def __init__(
        self,
        item_vectors: np.ndarray,
        item_id_map: tp.Union[IdMap, tp.Dict[ExternalId, InternalId]],
        index_top_k: int = 0,
        distance: Distance = Distance.COSINE,
        approximate: bool = False,
        recall_target: float = 0.95,
        device: str = "cuda",
    ) -> None:
        resolve_device(device)
        self.device = device
        self.approximate = approximate
        # recall/speed dial for approximate mode — the counterpart of HNSW's
        # efSearch in the reference (tools/ann.py efS=100 default)
        self.recall_target = recall_target
        self.item_vectors = np.asarray(item_vectors, dtype=np.float32)
        if isinstance(item_id_map, dict):
            self.item_id_map = IdMap.from_dict(item_id_map)
        else:
            self.item_id_map = item_id_map
        self.index_top_k = index_top_k
        self.distance = distance
        self._engine: tp.Optional[TopKEngine] = None

    def fit(self: T, verbose: bool = False) -> T:
        """Load the item table to the device (the reference builds an HNSW index here)."""
        self._engine = self._new_engine()
        return self

    def _new_engine(self) -> TopKEngine:
        return TopKEngine(
            self.item_vectors,
            distance=self.distance,
            approximate=self.approximate,
            recall_target=self.recall_target,
            device=self.device,
        )

    def __getstate__(self) -> tp.Dict[str, tp.Any]:
        state = self.__dict__.copy()
        state["_engine"] = None  # the device table is rebuilt on self.device at the first query after load
        return state

    def _require_engine(self) -> TopKEngine:
        if self._engine is None:
            self._engine = self._new_engine()
        return self._engine

    def _compute_sorted_similar(self, input_vectors: np.ndarray, top_n: int) -> np.ndarray:
        engine = self._require_engine()
        k = min(top_n + self.index_top_k, engine.n_objects)
        idx, _, valid = engine.query_batch(np.asarray(input_vectors, dtype=np.float32), k)
        # invalid entries (shouldn't occur without filters) pushed to the end
        return np.where(valid, idx, -1)

    @staticmethod
    def _truncate_item_list(
        top_n: int,
        item_arrays: tp.Sequence[InternalIds],
        available_items: tp.Optional[tp.Sequence[InternalIds]] = None,
        self_indices: tp.Optional[InternalIds] = None,
    ) -> tp.Sequence[InternalIds]:
        """Intersect candidate lists with per-query whitelists, drop self ids,
        truncate to top_n (reference ann.py:146-190)."""
        out = []
        if available_items is not None:
            for idx, (item_array, available_list) in enumerate(zip(item_arrays, available_items)):
                available_set: tp.Set[int] = set(np.asarray(available_list).tolist())
                if self_indices is not None:
                    available_set.discard(int(self_indices[idx]))
                truncated = [int(rec) for rec in item_array if rec in available_set][:top_n]
                out.append(truncated)
            return out

        for idx, item_array in enumerate(item_arrays):
            self_id = int(self_indices[idx]) if self_indices is not None else None
            truncated = [int(rec) for rec in item_array if rec >= 0 and rec != self_id][:top_n]
            out.append(truncated)
        return out

    def _map_to_external_id(self, item_arrays: tp.Sequence[InternalIds]) -> tp.Sequence[ExternalIds]:
        return [self.item_id_map.convert_to_external(item_array) for item_array in item_arrays]


class UserToItemAnnRecommender(BaseAnnRecommender):
    """U2I retrieval over user/item vector tables
    (reference ann.py:200-355)."""

    def __init__(
        self,
        user_vectors: np.ndarray,
        item_vectors: np.ndarray,
        user_id_map: tp.Union[IdMap, tp.Dict[ExternalId, InternalId]],
        item_id_map: tp.Union[IdMap, tp.Dict[ExternalId, InternalId]],
        index_top_k: int = 0,
        distance: Distance = Distance.COSINE,
        approximate: bool = False,
        recall_target: float = 0.95,
        device: str = "cuda",
    ) -> None:
        super().__init__(item_vectors, item_id_map, index_top_k, distance, approximate, recall_target, device)
        self.user_vectors = np.asarray(user_vectors, dtype=np.float32)
        if isinstance(user_id_map, dict):
            self.user_id_map = IdMap.from_dict(user_id_map)
        else:
            self.user_id_map = user_id_map
        if self.user_vectors.shape[1] != self.item_vectors.shape[1]:
            raise ValueError("User and item vectors must have the same dimensionality")

    def get_item_list_for_user(
        self, user_id: ExternalId, top_n: int, item_ids: tp.Optional[ExternalIds] = None
    ) -> ExternalIds:
        """Top-n items for one user, optionally restricted to `item_ids`."""
        user_id_ = self.user_id_map.convert_to_internal([user_id])
        item_ids_ = None
        if item_ids is not None:
            item_ids_ = [self.item_id_map.convert_to_internal(item_ids)]
        return self._get_item_list_from_index(user_id_, top_n, item_ids_)[0]

    def get_item_list_for_user_batch(
        self,
        user_ids: ExternalIds,
        top_n: int,
        item_ids: tp.Optional[tp.Sequence[ExternalIds]] = None,
    ) -> tp.Sequence[ExternalIds]:
        """Batched top-n items with per-user whitelists."""
        user_ids_ = self.user_id_map.convert_to_internal(user_ids)
        item_ids_ = None
        if item_ids is not None:
            item_ids_ = [self.item_id_map.convert_to_internal(ids) for ids in item_ids]
        return self._get_item_list_from_index(user_ids_, top_n, item_ids_)

    def _get_item_list_from_index(
        self, user_ids: InternalIds, top_n: int, item_ids: tp.Optional[tp.Sequence[InternalIds]] = None
    ) -> tp.Sequence[ExternalIds]:
        user_vectors = self.user_vectors[np.asarray(user_ids)]
        ids = self._compute_sorted_similar(input_vectors=user_vectors, top_n=top_n)
        return self._map_to_external_id(self._truncate_item_list(top_n, ids, available_items=item_ids))


class ItemToItemAnnRecommender(BaseAnnRecommender):
    """I2I retrieval over the item vector table (reference ann.py:356-475)."""

    def get_item_list_for_item(
        self, item_id: ExternalId, top_n: int, item_available_ids: tp.Optional[ExternalIds] = None
    ) -> ExternalIds:
        """Top-n similar items for one item (self excluded)."""
        item_id_ = self.item_id_map.convert_to_internal([item_id])
        item_available_ids_ = None
        if item_available_ids is not None:
            item_available_ids_ = [self.item_id_map.convert_to_internal(item_available_ids)]
        return self._get_item_list_from_index(item_id_, top_n, item_available_ids_)[0]

    def get_item_list_for_item_batch(
        self,
        item_ids: ExternalIds,
        top_n: int,
        item_available_ids: tp.Optional[tp.Sequence[ExternalIds]] = None,
    ) -> tp.Sequence[ExternalIds]:
        """Batched top-n similar items with per-item whitelists."""
        item_ids_ = self.item_id_map.convert_to_internal(item_ids)
        item_available_ids_ = None
        if item_available_ids is not None:
            item_available_ids_ = [self.item_id_map.convert_to_internal(ids) for ids in item_available_ids]
        return self._get_item_list_from_index(item_ids_, top_n, item_available_ids_)

    def _get_item_list_from_index(
        self, item_ids: InternalIds, top_n: int, item_available_ids: tp.Optional[tp.Sequence[InternalIds]] = None
    ) -> tp.Sequence[ExternalIds]:
        item_ids_arr = np.asarray(item_ids)
        item_vectors = self.item_vectors[item_ids_arr]
        ids = self._compute_sorted_similar(input_vectors=item_vectors, top_n=top_n + 1)
        return self._map_to_external_id(
            self._truncate_item_list(top_n, ids, available_items=item_available_ids, self_indices=item_ids_arr)
        )
