"""MetricsApp: interactive metric-vs-metric scatter explorer for
cross_validate results.

Port of rectools_tpu/visuals/metrics_app.py; behavioral parity target:
reference rectools/visuals/metrics_app.py (``MetricsApp``). Data preparation and validation are dependency-free;
plotly/ipywidgets are imported only by the rendering entry points and a
missing install raises an informative ImportError there.
"""

import typing as tp

import pandas as pd

from ..columns import Columns

CHART_WIDTH = 800
CHART_HEIGHT = 600
CHART_TOP_MARGIN = 20
MODEL_LEGEND = "model"
# metadata values joined into trace names use ", " as the separator, so the
# values themselves must not contain it
_TRACE_NAME_SEP = ", "


def _plotly() -> tp.Tuple[tp.Any, tp.Any]:
    try:
        import plotly.express as px
        import plotly.graph_objects as go
    except ImportError as e:  # pragma: no cover
        raise ImportError("MetricsApp rendering needs the optional `plotly` package") from e
    return px, go


class MetricsApp:
    """Explore cross-validation metric trade-offs as a 2-D scatter with
    widget-driven axis/fold/metadata selection. Build via ``construct``."""

    def __init__(
        self,
        data: pd.DataFrame,
        metric_names: tp.List[str],
        meta_names: tp.List[str],
        show_legend: bool = True,
        auto_display: bool = True,
        scatter_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
    ):
        self.data = data
        self.metric_names = metric_names
        self.meta_names = meta_names
        self.show_legend = show_legend
        self.auto_display = auto_display
        self.scatter_kwargs = dict(scatter_kwargs or {})
        self.fig: tp.Any = None
        self._fold_frames: tp.Dict[int, pd.DataFrame] = {}
        self._avg_frame: tp.Optional[pd.DataFrame] = None
        if auto_display:
            self.display()

    @classmethod
    def construct(
        cls,
        models_metrics: pd.DataFrame,
        models_metadata: tp.Optional[pd.DataFrame] = None,
        show_legend: bool = True,
        auto_display: bool = True,
        scatter_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
    ) -> "MetricsApp":
        """Validate the metric rows (one per model or per model×fold), attach
        optional per-model metadata, and build the app."""
        cls._validate_models_metrics_base(models_metrics)
        cls._validate_models_metrics_split(models_metrics)

        special = (Columns.Model, Columns.Split)
        metric_names = [c for c in models_metrics.columns if c not in special]

        if models_metadata is None:
            meta_names: tp.List[str] = []
            data = models_metrics
        else:
            cls._validate_models_metadata(models_metadata)
            meta_names = [c for c in models_metadata.columns if c != Columns.Model]
            data = models_metrics.merge(models_metadata, on=Columns.Model, how="left")
        # trace names are "<meta>, <model>": scrub the separator out of values
        data = data.replace(_TRACE_NAME_SEP, " ", regex=True)

        return cls(data, metric_names, meta_names, show_legend, auto_display, scatter_kwargs)

    # ------------------------------------------------------------- properties

    @property
    def model_names(self) -> tp.List[str]:
        """Model names, sorted."""
        return sorted(self.data[Columns.Model].unique())

    @property
    def fold_ids(self) -> tp.Optional[tp.List[int]]:
        """Fold ids, sorted; None when the data has no split column."""
        if Columns.Split not in self.data.columns:
            return None
        return sorted(self.data[Columns.Split].unique())

    # ---------------------------------------------------------------- validate

    @staticmethod
    def _validate_models_metrics_base(models_metrics: pd.DataFrame) -> None:
        columns = models_metrics.columns
        if Columns.Model not in columns:
            raise KeyError(f"metrics frame has no {Columns.Model!r} column; columns: {list(columns)}")
        metric_columns = [c for c in columns if c not in (Columns.Model, Columns.Split)]
        if not metric_columns:
            raise KeyError("metrics frame carries no metric columns (only model/split)")
        if models_metrics[Columns.Model].isna().any():
            raise ValueError("metrics frame: model column contains missing values")
        has_splits = Columns.Split in columns
        if has_splits and models_metrics[Columns.Split].isna().any():
            raise ValueError("metrics frame: split column contains missing values")
        if not has_splits and models_metrics[Columns.Model].duplicated().any():
            raise ValueError("metrics frame without a split column must have one row per model")
        non_numeric = [c for c in metric_columns if not pd.api.types.is_numeric_dtype(models_metrics[c])]
        if non_numeric:
            raise ValueError(f"metric columns must be numeric; offending columns: {non_numeric}")

    @staticmethod
    def _validate_models_metrics_split(models_metrics: pd.DataFrame) -> None:
        if Columns.Split not in models_metrics.columns:
            return
        if models_metrics.duplicated(subset=[Columns.Model, Columns.Split]).any():
            raise ValueError("metrics frame has repeated (model, split) rows")
        per_model_splits = models_metrics.groupby(Columns.Model)[Columns.Split].agg(frozenset)
        if per_model_splits.nunique() > 1:
            raise ValueError(
                f"every model must be scored on the same folds; saw fold sets {set(per_model_splits)}"
            )

    @staticmethod
    def _validate_models_metadata(models_metadata: pd.DataFrame) -> None:
        if Columns.Model not in models_metadata.columns:
            raise KeyError(f"metadata frame has no {Columns.Model!r} column")
        if models_metadata[Columns.Model].isna().any():
            raise ValueError("metadata frame: model column contains missing values")
        if models_metadata[Columns.Model].duplicated().any():
            raise ValueError("metadata frame must have one row per model")

    # -------------------------------------------------------------- chart data

    def chart_data(self, fold: tp.Optional[int] = None) -> pd.DataFrame:
        """The frame the scatter renders: fold-averaged metrics per model
        (``fold=None``) or one fold's rows — usable headless, without the
        plotly/ipywidgets extras the rendering entry points need."""
        if fold is None:
            return self._make_chart_data_avg()
        return self._make_chart_data_fold(fold)

    def _make_chart_data_fold(self, fold_number: int) -> pd.DataFrame:
        """Rows of one fold (memoized)."""
        if fold_number not in self._fold_frames:
            picked = self.data[self.data[Columns.Split] == fold_number]
            self._fold_frames[fold_number] = picked.reset_index(drop=True)
        return self._fold_frames[fold_number]

    def _make_chart_data_avg(self) -> pd.DataFrame:
        """One row per model: metrics averaged over folds, metadata carried
        through (memoized)."""
        if self._avg_frame is None:
            plan = {name: "mean" for name in self.metric_names}
            plan.update({name: "first" for name in self.meta_names})
            self._avg_frame = self.data.groupby(Columns.Model).agg(plan).reset_index()
        return self._avg_frame

    # ------------------------------------------------------------------ render

    def _scatter(self, frame: pd.DataFrame, x: str, y: str, color_by: str, legend_title: str) -> tp.Any:
        """One plotly scatter; points colored by ``color_by`` and symbolled by
        model so model identity survives metadata coloring."""  # pragma: no cover
        px, _ = _plotly()
        options: tp.Dict[str, tp.Any] = {"width": CHART_WIDTH, "height": CHART_HEIGHT, **self.scatter_kwargs}
        frame = frame.sort_values(color_by).assign(**{color_by: frame[color_by].astype(str)})
        fig = px.scatter(frame, x=x, y=y, color=color_by, symbol=Columns.Model, **options)
        if color_by != Columns.Model:
            for trace, meta_value, model in zip(fig.data, frame[color_by], frame[Columns.Model]):
                trace.name = f"{meta_value}{_TRACE_NAME_SEP}{model}"
        fig.update_layout(
            margin={"t": CHART_TOP_MARGIN}, legend_title=legend_title, showlegend=self.show_legend
        )
        fig.update_coloraxes(showscale=False)
        return fig

    def display(self) -> None:  # pragma: no cover - interactive widget
        """Render the widget panel + live figure in a notebook."""
        import ipywidgets as widgets
        from IPython.display import display as ipy_display

        _, go = _plotly()

        second_metric = self.metric_names[1] if len(self.metric_names) > 1 else self.metric_names[0]
        pick_x = widgets.Dropdown(description="Metric X:", options=self.metric_names, value=self.metric_names[0])
        pick_y = widgets.Dropdown(description="Metric Y:", options=self.metric_names, value=second_metric)
        avg_folds = widgets.Checkbox(description="Average folds", value=True)
        pick_fold = widgets.Dropdown(
            description="Fold number:",
            options=self.fold_ids or [],
            value=self.fold_ids[0] if self.fold_ids else None,
        )
        color_by_meta = widgets.Checkbox(description="Use metadata", value=False)
        pick_meta = widgets.Dropdown(
            description="Color by:",
            options=self.meta_names,
            value=self.meta_names[0] if self.meta_names else None,
        )

        def current_frame() -> pd.DataFrame:
            if avg_folds.value or pick_fold.value is None:
                return self._make_chart_data_avg()
            return self._make_chart_data_fold(pick_fold.value)

        self.fig = self._scatter(current_frame(), pick_x.value, pick_y.value, Columns.Model, MODEL_LEGEND)
        live = go.FigureWidget(data=self.fig.data, layout=self.fig.layout)

        def refresh(_event: tp.Any) -> None:
            if color_by_meta.value and pick_meta.value is not None:
                color_by = pick_meta.value
                legend = f"{pick_meta.value}{_TRACE_NAME_SEP}{MODEL_LEGEND}"
            else:
                color_by, legend = Columns.Model, MODEL_LEGEND
            self.fig = self._scatter(current_frame(), pick_x.value, pick_y.value, color_by, legend)
            with live.batch_update():
                for shown, fresh in zip(live.data, self.fig.data):
                    shown.x, shown.y, shown.name = fresh.x, fresh.y, fresh.name
                live.layout = self.fig.layout
            pick_fold.layout.visibility = "hidden" if avg_folds.value else "visible"
            pick_meta.layout.visibility = "visible" if color_by_meta.value else "hidden"

        controls = [pick_x, pick_y, avg_folds, pick_fold, color_by_meta, pick_meta]
        for control in controls:
            control.observe(refresh, "value")

        axis_row = widgets.HBox([pick_x, pick_y])
        fold_rows = [widgets.HBox([avg_folds, pick_fold])] if self.fold_ids else []
        panels = widgets.Tab()
        panel_children = [widgets.VBox([*fold_rows, axis_row])]
        panels.set_title(0, "Metrics")
        if self.meta_names:
            panel_children.append(widgets.VBox([widgets.HBox([color_by_meta, pick_meta])]))
            panels.set_title(1, "Metadata")
        panels.children = panel_children

        ipy_display(widgets.VBox([panels, live]))
        refresh(None)
