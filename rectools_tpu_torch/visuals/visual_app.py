"""Jupyter widget apps for eyeballing recommendations.

Port of rectools_tpu/visuals/visual_app.py. Behavioral parity with
reference rectools/visuals/visual_app.py (the
`AppDataStorage` + `VisualApp` / `ItemToItemVisualApp` surface: per-request
interaction/reco tables enriched with item data, random request sampling,
CSV save/load round-trips, ipywidgets toggle UI), re-organized around a
small set of frame-slicing helpers instead of the reference's grouping
pipeline. Host-only code — nothing here touches the device.
"""

import typing as tp
from pathlib import Path

import numpy as np
import pandas as pd

from ..columns import Columns
from ..types import ExternalId

TablesDict = tp.Dict[tp.Hashable, pd.DataFrame]

MIN_WIDTH_LIMIT = 10
REQUEST_NAMES_COL = "request_name"
REQUEST_IDS_COL = "request_id"

_INTERACTIONS_FILE = "interactions.csv"
_RECO_FILE = "recommendations.csv"
_REQUESTS_FILE = "requests.csv"

VisualAppT = tp.TypeVar("VisualAppT", bound="VisualAppBase")


class StorageFiles:
    """File names used by `AppDataStorage.save` / `load` (kept as a class for
    reference API parity)."""

    Interactions = _INTERACTIONS_FILE
    Recommendations = _RECO_FILE
    Requests = _REQUESTS_FILE


def _split_frame_by(df: pd.DataFrame, key_col: str) -> TablesDict:
    """{key -> sub-frame without the key column}, insertion-ordered by key."""
    return {
        key: part.drop(columns=[key_col]).reset_index(drop=True)
        for key, part in df.groupby(key_col, sort=True)
    }


def _rows_for_request(df: pd.DataFrame, id_col: str, request_id: ExternalId) -> pd.DataFrame:
    return df.loc[df[id_col] == request_id].drop(columns=[id_col]).reset_index(drop=True)


class AppDataStorage:
    """Per-request interaction and recommendation tables for the widget apps.

    The canonical state is the four fields of the reference storage
    (`is_u2i`, `id_col`, `selected_requests`, `grouped_interactions`,
    `grouped_reco`); construction goes through :meth:`from_raw` or
    :meth:`load`.
    """

    def __init__(
        self,
        is_u2i: bool,
        id_col: str,
        selected_requests: tp.Dict[tp.Hashable, ExternalId],
        grouped_interactions: TablesDict,
        grouped_reco: tp.Dict[tp.Hashable, TablesDict],
    ) -> None:
        self.is_u2i = is_u2i
        self.id_col = id_col
        self.selected_requests = selected_requests
        self.grouped_interactions = grouped_interactions
        self.grouped_reco = grouped_reco

    @property
    def request_names(self) -> tp.List[tp.Hashable]:
        """Display names of the selected requests."""
        return list(self.selected_requests)

    @property
    def model_names(self) -> tp.List[tp.Hashable]:
        """Names of the models being compared."""
        return list(self.grouped_reco)

    # ------------------------------------------------------------ construction

    @classmethod
    def from_raw(
        cls,
        reco: tp.Union[pd.DataFrame, TablesDict],
        item_data: pd.DataFrame,
        selected_requests: tp.Optional[tp.Dict[tp.Hashable, ExternalId]] = None,
        is_u2i: bool = True,
        n_random_requests: int = 0,
        interactions: tp.Optional[pd.DataFrame] = None,
    ) -> "AppDataStorage":
        """Build storage from raw reco tables, item data and (u2i)
        interactions."""
        id_col = Columns.User if is_u2i else Columns.TargetItem
        requests = dict(selected_requests) if selected_requests else {}
        if not requests and n_random_requests == 0:
            entity = "users" if is_u2i else "items"
            raise ValueError(f"Please specify `n_random_{entity}` > 0 or provide `selected_{entity}`")

        if isinstance(reco, pd.DataFrame):
            if Columns.Model not in reco.columns:
                raise KeyError(f"Missing `{Columns.Model}` column in `reco` DataFrame")
            reco = _split_frame_by(reco, Columns.Model)
        for model_name, model_reco in reco.items():
            missing = {id_col, Columns.Item} - set(model_reco.columns)
            if missing:
                raise KeyError(f"Missed columns {missing} in {model_name} recommendations df")
        if Columns.Item not in item_data.columns:
            raise KeyError(f"Missed {Columns.Item} column in item_data")

        if n_random_requests > 0:
            requests.update(cls._sample_random_requests(reco, id_col, requests, n_random_requests))

        if is_u2i:
            if interactions is None:
                raise ValueError("For u2i reco you must specify interactions")
        else:
            if interactions is not None:
                raise ValueError("For i2i reco you must not specify interactions")
            # i2i "interactions" are just the requests themselves, so the
            # request item shows up in the interactions panel
            request_items = pd.unique(np.concatenate([df[Columns.TargetItem].to_numpy() for df in reco.values()]))
            interactions = pd.DataFrame({Columns.TargetItem: request_items, Columns.Item: request_items})

        grouped_interactions = {
            name: _rows_for_request(interactions, id_col, rid).merge(item_data, how="left", on=Columns.Item)
            for name, rid in requests.items()
        }
        grouped_reco = {
            model_name: {
                name: item_data.merge(
                    _rows_for_request(model_reco, id_col, rid),
                    how="right",
                    on=Columns.Item,
                    suffixes=["_item", "_reco"],
                )
                for name, rid in requests.items()
            }
            for model_name, model_reco in reco.items()
        }
        return cls(
            is_u2i=is_u2i,
            id_col=id_col,
            selected_requests=requests,
            grouped_interactions=grouped_interactions,
            grouped_reco=grouped_reco,
        )

    @staticmethod
    def _sample_random_requests(
        reco: TablesDict,
        id_col: str,
        already_selected: tp.Dict[tp.Hashable, ExternalId],
        n_random_requests: int,
    ) -> tp.Dict[tp.Hashable, ExternalId]:
        """Draw extra request ids uniformly from the reco tables, skipping ids
        that were selected explicitly."""
        candidates = pd.unique(np.concatenate([df[id_col].to_numpy() for df in reco.values()]))
        taken = set(already_selected.values())
        pool = np.array([cand for cand in candidates if cand not in taken])
        n_draw = min(len(pool), n_random_requests)
        drawn = np.random.default_rng().choice(pool, size=n_draw, replace=False)
        return {f"random_{i + 1}": rid for i, rid in enumerate(drawn)}

    # ------------------------------------------------------------- persistence

    def _flat_interactions(self) -> pd.DataFrame:
        parts = []
        for name, table in self.grouped_interactions.items():
            parts.append(table.assign(**{self.id_col: self.selected_requests[name]}))
        return pd.concat(parts, sort=False, ignore_index=True)

    def _flat_reco(self) -> pd.DataFrame:
        parts = []
        for model_name, per_request in self.grouped_reco.items():
            for name, table in per_request.items():
                parts.append(
                    table.assign(**{self.id_col: self.selected_requests[name], Columns.Model: model_name})
                )
        return pd.concat(parts, sort=False, ignore_index=True)

    def save(self, folder_name: str, overwrite: bool = False) -> None:
        """Write three CSVs (interactions, recommendations, requests)."""
        folder = Path(folder_name)
        folder.mkdir(parents=True, exist_ok=True)
        mode = "w" if overwrite else "x"
        self._flat_interactions().to_csv(folder / _INTERACTIONS_FILE, index=False, mode=mode)
        self._flat_reco().to_csv(folder / _RECO_FILE, index=False, mode=mode)
        pd.Series(self.selected_requests, name=REQUEST_IDS_COL).to_csv(
            folder / _REQUESTS_FILE, index_label=REQUEST_NAMES_COL, mode=mode
        )

    @classmethod
    def load(cls, folder_name: str) -> "AppDataStorage":
        """Rebuild storage from a folder written by `save`."""
        folder = Path(folder_name)
        interactions = pd.read_csv(folder / _INTERACTIONS_FILE)
        reco_flat = pd.read_csv(folder / _RECO_FILE)
        requests = pd.read_csv(folder / _REQUESTS_FILE, index_col=REQUEST_NAMES_COL)[REQUEST_IDS_COL].to_dict()

        has_user = Columns.User in interactions.columns
        has_target = Columns.TargetItem in interactions.columns
        if has_user and has_target:
            raise ValueError(
                f"Unable to create VisualApp. Saved interactions have both columns: "
                f"{Columns.TargetItem} and {Columns.User}"
            )
        if not has_user and not has_target:
            raise ValueError(
                f"Unable to create VisualApp. Saved interactions don't have any of the columns: "
                f"{Columns.TargetItem} or {Columns.User}"
            )
        id_col = Columns.User if has_user else Columns.TargetItem

        grouped_interactions = {
            name: _rows_for_request(interactions, id_col, rid) for name, rid in requests.items()
        }
        grouped_reco = {
            model_name: {
                # item data was merged before save; drop the all-NaN columns
                # the CSV round trip manufactures for models lacking a column
                name: _rows_for_request(model_reco, id_col, rid).dropna(axis=1, how="all")
                for name, rid in requests.items()
            }
            for model_name, model_reco in _split_frame_by(reco_flat, Columns.Model).items()
        }
        return cls(
            is_u2i=has_user,
            id_col=id_col,
            selected_requests=requests,
            grouped_interactions=grouped_interactions,
            grouped_reco=grouped_reco,
        )


class VisualAppBase:
    """ipywidgets viewer over an `AppDataStorage`: toggle a request and a
    model, see the request's interactions next to each model's list."""

    def __init__(
        self,
        data_storage: AppDataStorage,
        auto_display: bool = True,
        formatters: tp.Optional[tp.Dict[str, tp.Callable]] = None,
        rows_limit: int = 20,
        min_width: int = 50,
    ) -> None:
        if min_width <= MIN_WIDTH_LIMIT:
            raise ValueError(f"`min_width` must be greater then {MIN_WIDTH_LIMIT}. {min_width} specified")
        self.data_storage = data_storage
        self.formatters = formatters or {}
        self.rows_limit = rows_limit
        self.min_width = min_width
        if auto_display:
            self.display()

    # ipywidgets/IPython are imported lazily so the library stays importable
    # (and testable) in headless environments

    def _render_table_tab(self, title: str, df: pd.DataFrame) -> tp.Any:
        import ipywidgets as widgets

        html = df.to_html(
            escape=False, index=False, formatters=self.formatters, max_rows=self.rows_limit, border=0
        )
        html = html.replace("<td>", '<td align="center">')
        html = html.replace("<th>", f'<th style="text-align: center; min-width: {self.min_width}px;">')
        tab = widgets.Tab(children=[widgets.HTML(value=html)])
        tab.set_title(index=0, title=title)
        return tab

    def _show_request(self, request_name: str) -> None:
        from IPython.display import display
        import ipywidgets as widgets

        request_id = self.data_storage.selected_requests[request_name]
        display(widgets.HTML(value=f"{self.data_storage.id_col}: {request_id}"))

    def _show_interactions(self, request_name: str) -> None:
        from IPython.display import display

        display(self._render_table_tab("Interactions", self.data_storage.grouped_interactions[request_name]))

    def _show_model(self, model_name: str) -> None:
        from IPython.display import display
        import ipywidgets as widgets

        display(widgets.HTML(value=f"Model name: {model_name}"))

    def _show_reco(self, request_name: str, model_name: str) -> None:
        from IPython.display import display

        display(self._render_table_tab("Recommended", self.data_storage.grouped_reco[model_name][request_name]))

    def display(self) -> None:
        """Render the widget tree."""
        import ipywidgets as widgets
        from IPython.display import display

        pick_request = widgets.ToggleButtons(
            options=self.data_storage.request_names, description="Target:", disabled=False, button_style="warning"
        )
        pick_model = widgets.ToggleButtons(
            options=self.data_storage.model_names, description="Model:", disabled=False, button_style="success"
        )
        panels = [
            pick_request,
            widgets.interactive_output(self._show_request, {"request_name": pick_request}),
            widgets.interactive_output(self._show_interactions, {"request_name": pick_request}),
            pick_model,
            widgets.interactive_output(self._show_model, {"model_name": pick_model}),
            widgets.interactive_output(self._show_reco, {"request_name": pick_request, "model_name": pick_model}),
        ]
        display(widgets.VBox(panels))

    def save(self, folder_name: str, overwrite: bool = False) -> None:
        """Persist the underlying data storage."""
        self.data_storage.save(folder_name, overwrite)

    @classmethod
    def load(
        cls: tp.Type[VisualAppT],
        folder_name: str,
        auto_display: bool = True,
        formatters: tp.Optional[tp.Dict[str, tp.Callable]] = None,
        rows_limit: int = 20,
        min_width: int = 100,
    ) -> VisualAppT:
        """Re-create the app from a saved data folder."""
        return cls(
            data_storage=AppDataStorage.load(folder_name),
            auto_display=auto_display,
            formatters=formatters,
            rows_limit=rows_limit,
            min_width=min_width,
        )


class VisualApp(VisualAppBase):
    """U2I inspection app."""

    @classmethod
    def construct(
        cls,
        reco: tp.Union[pd.DataFrame, TablesDict],
        interactions: pd.DataFrame,
        item_data: pd.DataFrame,
        selected_users: tp.Optional[tp.Dict[tp.Hashable, ExternalId]] = None,
        n_random_users: int = 0,
        auto_display: bool = True,
        formatters: tp.Optional[tp.Dict[str, tp.Callable]] = None,
        rows_limit: int = 20,
        min_width: int = 100,
    ) -> "VisualApp":
        """Build the app from raw u2i reco + interactions + item data."""
        storage = AppDataStorage.from_raw(
            reco=reco,
            item_data=item_data,
            interactions=interactions,
            selected_requests=selected_users,
            is_u2i=True,
            n_random_requests=n_random_users,
        )
        return cls(storage, auto_display, formatters, rows_limit, min_width)


class ItemToItemVisualApp(VisualAppBase):
    """I2I inspection app."""

    @classmethod
    def construct(
        cls,
        reco: tp.Union[pd.DataFrame, TablesDict],
        item_data: pd.DataFrame,
        selected_items: tp.Optional[tp.Dict[tp.Hashable, ExternalId]] = None,
        n_random_items: int = 0,
        auto_display: bool = True,
        formatters: tp.Optional[tp.Dict[str, tp.Callable]] = None,
        rows_limit: int = 20,
        min_width: int = 100,
    ) -> "ItemToItemVisualApp":
        """Build the app from raw i2i reco + item data."""
        storage = AppDataStorage.from_raw(
            reco=reco,
            item_data=item_data,
            selected_requests=selected_items,
            is_u2i=False,
            n_random_requests=n_random_items,
        )
        return cls(storage, auto_display, formatters, rows_limit, min_width)
