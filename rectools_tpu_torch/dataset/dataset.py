"""Dataset container.

Behavioral parity with reference rectools/dataset/dataset.py:99-438:
frozen container of user/item IdMaps + Interactions + optional features;
hot/warm semantics (hot = appears in interactions, warm = only has features);
pydantic schema for checkpoint reconstruction; `filter_interactions` produces a
second-level dataset for cross-validation folds.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd
from scipy import sparse

from ..columns import Columns
from ..utils.config import BaseConfig
from .features import AbsentIdError, DenseFeatures, Features, SparseFeatures
from .identifiers import IdMap
from .interactions import Interactions


def _serialize_feature_name(name: tp.Any) -> tp.Any:
    if isinstance(name, (list, tuple)):
        return [_serialize_feature_name(x) for x in name]
    if isinstance(name, (str, int, float)) or name is None:
        return name
    return str(name)


class BaseFeaturesSchema(BaseConfig):
    names: tp.Tuple[tp.Any, ...]


class DenseFeaturesSchema(BaseFeaturesSchema):
    kind: tp.Literal["dense"] = "dense"


class SparseFeaturesSchema(BaseFeaturesSchema):
    kind: tp.Literal["sparse"] = "sparse"
    cat_feature_indices: tp.List[int]
    cat_n_stored_values: int


FeaturesSchema = tp.Union[DenseFeaturesSchema, SparseFeaturesSchema]


class IdMapSchema(BaseConfig):
    size: int
    dtype: str


class EntitySchema(BaseConfig):
    n_hot: int
    id_map: IdMapSchema
    features: tp.Optional[FeaturesSchema] = None


class DatasetSchema(BaseConfig):
    n_interactions: int
    users: EntitySchema
    items: EntitySchema


DatasetSchemaDict = tp.Dict[str, tp.Any]


@attr.s(slots=True, frozen=True)
class Dataset:
    """Frozen container for all model-facing data.

    Create via :meth:`construct`, not directly.
    """

    user_id_map: IdMap = attr.ib()
    item_id_map: IdMap = attr.ib()
    interactions: Interactions = attr.ib()
    user_features: tp.Optional[Features] = attr.ib(default=None)
    item_features: tp.Optional[Features] = attr.ib(default=None)

    @property
    def n_hot_users(self) -> int:
        """Users 0..n_hot-1 are present in interactions; the rest are warm."""
        if len(self.interactions.df) == 0:
            return 0
        return int(self.interactions.df[Columns.User].max()) + 1

    @property
    def n_hot_items(self) -> int:
        """Items 0..n_hot-1 are present in interactions; the rest are warm."""
        if len(self.interactions.df) == 0:
            return 0
        return int(self.interactions.df[Columns.Item].max()) + 1

    def get_hot_user_features(self) -> tp.Optional[Features]:
        if self.user_features is None:
            return None
        return self.user_features.take(np.arange(self.n_hot_users))

    def get_hot_item_features(self) -> tp.Optional[Features]:
        if self.item_features is None:
            return None
        return self.item_features.take(np.arange(self.n_hot_items))

    @staticmethod
    def _get_feature_schema(features: tp.Optional[Features]) -> tp.Optional[FeaturesSchema]:
        if features is None:
            return None
        if isinstance(features, SparseFeatures):
            return SparseFeaturesSchema(
                names=tuple(_serialize_feature_name(n) for n in features.names),
                cat_feature_indices=features.cat_feature_indices.tolist(),
                cat_n_stored_values=int(features.get_cat_features().values.nnz),
            )
        return DenseFeaturesSchema(names=features.names)

    def get_schema(self) -> DatasetSchemaDict:
        """Dataset schema dict for checkpoint reconstruction (reference dataset.py:139-174)."""
        schema = DatasetSchema(
            n_interactions=int(self.interactions.df.shape[0]),
            users=EntitySchema(
                n_hot=self.n_hot_users,
                id_map=IdMapSchema(size=self.user_id_map.size, dtype=self.user_id_map.external_dtype.str),
                features=self._get_feature_schema(self.user_features),
            ),
            items=EntitySchema(
                n_hot=self.n_hot_items,
                id_map=IdMapSchema(size=self.item_id_map.size, dtype=self.item_id_map.external_dtype.str),
                features=self._get_feature_schema(self.item_features),
            ),
        )
        return schema.model_dump(mode="json")

    @classmethod
    def construct(
        cls,
        interactions_df: pd.DataFrame,
        user_features_df: tp.Optional[pd.DataFrame] = None,
        cat_user_features: tp.Iterable[str] = (),
        make_dense_user_features: bool = False,
        item_features_df: tp.Optional[pd.DataFrame] = None,
        cat_item_features: tp.Iterable[str] = (),
        make_dense_item_features: bool = False,
        keep_extra_cols: bool = False,
    ) -> "Dataset":
        """Create a dataset from raw interaction and feature tables
        (reference dataset.py:208)."""
        for col in (Columns.User, Columns.Item):
            if col not in interactions_df:
                raise KeyError(f"Column '{col}' must be present in `interactions_df`")
        user_id_map = IdMap.from_values(interactions_df[Columns.User].to_numpy())
        item_id_map = IdMap.from_values(interactions_df[Columns.Item].to_numpy())
        interactions = Interactions.from_raw(interactions_df, user_id_map, item_id_map, keep_extra_cols)

        user_features, user_id_map = cls._make_features(
            user_features_df, cat_user_features, make_dense_user_features, user_id_map, Columns.User, "user"
        )
        item_features, item_id_map = cls._make_features(
            item_features_df, cat_item_features, make_dense_item_features, item_id_map, Columns.Item, "item"
        )
        return cls(user_id_map, item_id_map, interactions, user_features, item_features)

    @staticmethod
    def _make_features(
        df: tp.Optional[pd.DataFrame],
        cat_features: tp.Iterable[str],
        make_dense: bool,
        id_map: IdMap,
        possible_id_col: str,
        feature_type: str,
    ) -> tp.Tuple[tp.Optional[Features], IdMap]:
        if df is None:
            return None, id_map
        id_col = possible_id_col if possible_id_col in df else "id"
        id_map = id_map.add_ids(df[id_col].to_numpy(), raise_if_already_present=False)
        if make_dense:
            try:
                return DenseFeatures.from_dataframe(df, id_map, id_col=id_col), id_map
            except AbsentIdError:
                raise ValueError(
                    f"An error has occurred while constructing {feature_type} features: "
                    "When using dense features all ids from interactions must be present in features table"
                )
        return SparseFeatures.from_flatten(df, id_map, cat_features, id_col=id_col), id_map

    def get_user_item_matrix(
        self,
        include_weights: bool = True,
        include_warm_users: bool = False,
        include_warm_items: bool = False,
        dtype: tp.Any = np.float32,
    ) -> sparse.csr_matrix:
        """User-item CSR, optionally resized to include warm rows/cols of zeros
        (reference dataset.py:314)."""
        matrix = self.interactions.get_user_item_matrix(include_weights, dtype)
        n_rows = self.user_id_map.size if include_warm_users else matrix.shape[0]
        n_cols = self.item_id_map.size if include_warm_items else matrix.shape[1]
        matrix.resize(n_rows, n_cols)
        return matrix

    def get_raw_interactions(
        self,
        include_weight: bool = True,
        include_datetime: bool = True,
        include_extra_cols: bool = True,
    ) -> pd.DataFrame:
        """Interactions with external ids (reference dataset.py:350)."""
        return self.interactions.to_external(
            self.user_id_map, self.item_id_map, include_weight, include_datetime, include_extra_cols
        )

    def filter_interactions(
        self,
        row_indexes_to_keep: np.ndarray,
        keep_external_ids: bool = True,
        keep_features_for_removed_entities: bool = True,
    ) -> "Dataset":
        """Fold dataset with re-mapped (2nd-level) ids (reference dataset.py:376)."""
        interactions_df = self.interactions.df.iloc[row_indexes_to_keep]

        user_id_map = IdMap.from_values(interactions_df[Columns.User].to_numpy())
        item_id_map = IdMap.from_values(interactions_df[Columns.Item].to_numpy())
        interactions = Interactions.from_raw(interactions_df, user_id_map, item_id_map, keep_extra_cols=True)

        def _handle_features(
            features: tp.Optional[Features], target_id_map: IdMap
        ) -> tp.Tuple[tp.Optional[Features], IdMap]:
            if features is None:
                return None, target_id_map
            if keep_features_for_removed_entities:
                all_ids = np.arange(len(features))
                target_id_map = target_id_map.add_ids(all_ids, raise_if_already_present=False)
            needed_ids = target_id_map.get_external_sorted_by_internal()
            return features.take(needed_ids), target_id_map

        user_features_new, user_id_map = _handle_features(self.user_features, user_id_map)
        item_features_new, item_id_map = _handle_features(self.item_features, item_id_map)

        if keep_external_ids:
            user_id_map = IdMap(self.user_id_map.convert_to_external(user_id_map.external_ids))
            item_id_map = IdMap(self.item_id_map.convert_to_external(item_id_map.external_ids))

        return Dataset(
            user_id_map=user_id_map,
            item_id_map=item_id_map,
            interactions=interactions,
            user_features=user_features_new,
            item_features=item_features_new,
        )
