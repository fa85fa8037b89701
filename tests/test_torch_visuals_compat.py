"""The port's visual apps' data half (``rectools_tpu_torch/visuals``) and
its reference-config migration (``rectools_tpu_torch/compat.py``) held
against the JAX package's on the CPU: the cases of
tests/visuals/test_visuals.py and tests/test_compat_migration.py run through
both packages.

Tolerances: none. Both halves are pandas and numpy with no device, so the
storages' frames, request maps, chart data and translated configs are
identical; where the apps draw random requests, both packages draw from the
same seeded generator. The translated ALS fits on the CPU in each package
and recommends the same users and counts (its factors come from each
package's own draws).
"""

import typing as tp
import warnings

import numpy as np
import pandas as pd
import pytest

from rectools_tpu_torch import Columns, models
from rectools_tpu_torch.compat import CatBoostRerankerUnavailable, translate_reference_config
from rectools_tpu_torch.models import model_from_config
from rectools_tpu_torch.visuals import AppDataStorage, ItemToItemVisualApp, MetricsApp, VisualApp

from .models.data import INTERACTIONS

RECO_U2I = pd.DataFrame(
    {
        Columns.User: [1, 1, 2, 2, 1, 2],
        Columns.Item: [11, 12, 11, 13, 12, 11],
        Columns.Score: [0.9, 0.8, 0.7, 0.6, 0.95, 0.85],
        Columns.Model: ["m1", "m1", "m1", "m1", "m2", "m2"],
    }
)
INTERACTIONS_SMALL = pd.DataFrame({Columns.User: [1, 1, 2], Columns.Item: [13, 11, 12]})
ITEM_DATA = pd.DataFrame({Columns.Item: [11, 12, 13], "title": ["a", "b", "c"]})
METRICS = pd.DataFrame(
    {
        Columns.Model: ["m1", "m2", "m1", "m2"],
        Columns.Split: [0, 0, 1, 1],
        "prec@10": [0.1, 0.2, 0.3, 0.4],
        "recall@10": [0.5, 0.6, 0.7, 0.8],
    }
)


@pytest.fixture(autouse=True)
def seeded_requests(monkeypatch: pytest.MonkeyPatch) -> None:
    """Random requests come from ``np.random.default_rng()``: seed every
    such call, so that both packages draw the same requests."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: real(7 if seed is None else seed))


def _jax_visuals() -> tp.Any:
    import rectools_tpu.visuals as jax_visuals

    return jax_visuals


def _storages(**kwargs: tp.Any) -> tp.Tuple[AppDataStorage, tp.Any]:
    return AppDataStorage.from_raw(**kwargs), _jax_visuals().AppDataStorage.from_raw(**kwargs)


def _same_storage(got: tp.Any, ref: tp.Any) -> None:
    assert (got.is_u2i, got.id_col, got.selected_requests) == (ref.is_u2i, ref.id_col, ref.selected_requests)
    assert got.grouped_interactions.keys() == ref.grouped_interactions.keys()
    for name, frame in got.grouped_interactions.items():
        pd.testing.assert_frame_equal(frame, ref.grouped_interactions[name])
    assert list(got.grouped_reco) == list(ref.grouped_reco)
    for model, per_request in got.grouped_reco.items():
        assert list(per_request) == list(ref.grouped_reco[model])
        for name, frame in per_request.items():
            pd.testing.assert_frame_equal(frame, ref.grouped_reco[model][name])


def _both_raise(exc: tp.Type[Exception], **kwargs: tp.Any) -> None:
    with pytest.raises(exc) as got:
        AppDataStorage.from_raw(**kwargs)
    with pytest.raises(exc) as ref:
        _jax_visuals().AppDataStorage.from_raw(**kwargs)
    assert str(got.value) == str(ref.value)


# ------------------------------------------------------------------ tests/visuals/test_visuals.py


class TestAppDataStorage:
    def test_from_raw_u2i(self) -> None:
        storage, ref = _storages(reco=RECO_U2I, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL,
                                 selected_requests={"first": 1, "second": 2})
        assert storage.is_u2i
        assert storage.request_names == ["first", "second"]
        assert set(storage.model_names) == {"m1", "m2"}
        assert "title" in storage.grouped_reco["m1"]["first"].columns
        assert set(storage.grouped_interactions["first"][Columns.Item]) == {13, 11}
        _same_storage(storage, ref)

    def test_save_load_round_trip(self, tmp_path: tp.Any) -> None:
        storage, ref = _storages(reco=RECO_U2I, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL,
                                 selected_requests={"first": 1})
        storage.save(str(tmp_path / "port"))
        ref.save(str(tmp_path / "jax"))
        for name in ("interactions.csv", "recommendations.csv", "requests.csv"):
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
        restored = AppDataStorage.load(str(tmp_path / "port"))
        assert restored.is_u2i and restored.selected_requests == {"first": 1}
        original = storage.grouped_reco["m1"]["first"]
        pd.testing.assert_frame_equal(
            original.reset_index(drop=True),
            restored.grouped_reco["m1"]["first"][original.columns].reset_index(drop=True),
            check_dtype=False,
        )
        _same_storage(restored, _jax_visuals().AppDataStorage.load(str(tmp_path / "jax")))

    def test_i2i(self) -> None:
        reco = RECO_U2I.rename(columns={Columns.User: Columns.TargetItem})
        storage, ref = _storages(reco=reco, item_data=ITEM_DATA, is_u2i=False, selected_requests={"t1": 1})
        assert not storage.is_u2i and storage.id_col == Columns.TargetItem
        _same_storage(storage, ref)

    def test_random_requests(self) -> None:
        storage, ref = _storages(reco=RECO_U2I, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL,
                                 n_random_requests=2)
        assert len(storage.request_names) == 2
        assert all(name.startswith("random_") for name in storage.request_names)
        _same_storage(storage, ref)

    def test_errors(self) -> None:
        _both_raise(ValueError, reco=RECO_U2I, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL)
        _both_raise(ValueError, reco=RECO_U2I, item_data=ITEM_DATA, selected_requests={"a": 1})
        _both_raise(KeyError, reco=RECO_U2I.drop(columns=[Columns.Model]), item_data=ITEM_DATA,
                    interactions=INTERACTIONS_SMALL, selected_requests={"a": 1})


class TestMetricsApp:
    def _apps(self, **kwargs: tp.Any) -> tp.Tuple[MetricsApp, tp.Any]:
        return (MetricsApp.construct(METRICS, auto_display=False, **kwargs),
                _jax_visuals().MetricsApp.construct(METRICS, auto_display=False, **kwargs))

    def test_construct_and_aggregations(self) -> None:
        app, ref = self._apps()
        assert app.model_names == ["m1", "m2"] == ref.model_names
        assert app.fold_ids == [0, 1] == ref.fold_ids
        avg = app._make_chart_data_avg()
        assert avg.loc[avg[Columns.Model] == "m1", "prec@10"].iloc[0] == pytest.approx(0.2)
        assert len(app._make_chart_data_fold(0)) == 2
        pd.testing.assert_frame_equal(avg, ref._make_chart_data_avg())
        pd.testing.assert_frame_equal(app._make_chart_data_fold(0), ref._make_chart_data_fold(0))

    def test_chart_data_public_accessor(self) -> None:
        app, ref = self._apps()
        pd.testing.assert_frame_equal(app.chart_data(), app._make_chart_data_avg())
        pd.testing.assert_frame_equal(app.chart_data(fold=1), app._make_chart_data_fold(1))
        assert app.chart_data(fold=1)["prec@10"].tolist() == [0.3, 0.4]
        for fold in (None, 0, 1):
            pd.testing.assert_frame_equal(app.chart_data(fold=fold), ref.chart_data(fold=fold))

    def test_metadata_merge(self) -> None:
        meta = pd.DataFrame({Columns.Model: ["m1", "m2"], "factors": [64, 32]})
        app, ref = self._apps(models_metadata=meta)
        assert app.meta_names == ["factors"] == ref.meta_names
        assert "factors" in app.data.columns
        pd.testing.assert_frame_equal(app.data, ref.data)
        pd.testing.assert_frame_equal(app.chart_data(), ref.chart_data())

    def test_validation_errors(self) -> None:
        bad_frames = [
            (KeyError, METRICS.drop(columns=[Columns.Model])),
            (ValueError, METRICS.drop(index=[3])),  # mismatched splits across models
            (ValueError, METRICS.assign(text_metric="x")),  # non-numeric metric
        ]
        for exc, frame in bad_frames:
            with pytest.raises(exc) as got:
                MetricsApp.construct(frame, auto_display=False)
            with pytest.raises(exc) as ref:
                _jax_visuals().MetricsApp.construct(frame, auto_display=False)
            assert str(got.value) == str(ref.value)


class TestAppDataStorageMore:
    def test_reco_dict_input(self) -> None:
        tables = {
            "m1": RECO_U2I[RECO_U2I[Columns.Model] == "m1"].drop(columns=[Columns.Model]),
            "m2": RECO_U2I[RECO_U2I[Columns.Model] == "m2"].drop(columns=[Columns.Model]),
        }
        storage, ref = _storages(reco=tables, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL,
                                 selected_requests={"a": 1})
        assert set(storage.model_names) == {"m1", "m2"}
        _same_storage(storage, ref)

    def test_missing_reco_columns_raise(self) -> None:
        _both_raise(KeyError, reco=RECO_U2I.drop(columns=[Columns.Item]), item_data=ITEM_DATA,
                    interactions=INTERACTIONS_SMALL, selected_requests={"a": 1})
        _both_raise(KeyError, reco=RECO_U2I, item_data=ITEM_DATA.drop(columns=[Columns.Item]),
                    interactions=INTERACTIONS_SMALL, selected_requests={"a": 1})

    def test_i2i_rejects_interactions(self) -> None:
        reco = RECO_U2I.rename(columns={Columns.User: Columns.TargetItem})
        _both_raise(ValueError, reco=reco, item_data=ITEM_DATA, is_u2i=False, interactions=INTERACTIONS_SMALL,
                    selected_requests={"a": 1})

    def test_random_requests_skip_explicit_selection(self) -> None:
        storage, ref = _storages(reco=RECO_U2I, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL,
                                 selected_requests={"picked": 1}, n_random_requests=1)
        assert storage.request_names[0] == "picked"
        (random_name,) = [n for n in storage.request_names if n != "picked"]
        assert storage.selected_requests[random_name] != 1  # only user 2 remains
        _same_storage(storage, ref)

    def test_save_refuses_overwrite_by_default(self, tmp_path: tp.Any) -> None:
        storage, ref = _storages(reco=RECO_U2I, item_data=ITEM_DATA, interactions=INTERACTIONS_SMALL,
                                 selected_requests={"a": 1})
        for store, folder in ((storage, tmp_path / "port"), (ref, tmp_path / "jax")):
            store.save(str(folder))
            with pytest.raises(FileExistsError):
                store.save(str(folder))
            store.save(str(folder), overwrite=True)  # explicit overwrite allowed

    def test_i2i_save_load_round_trip(self, tmp_path: tp.Any) -> None:
        reco = RECO_U2I.rename(columns={Columns.User: Columns.TargetItem})
        storage, ref = _storages(reco=reco, item_data=ITEM_DATA, is_u2i=False, selected_requests={"t": 1})
        storage.save(str(tmp_path / "port"))
        ref.save(str(tmp_path / "jax"))
        restored = AppDataStorage.load(str(tmp_path / "port"))
        assert not restored.is_u2i and restored.id_col == Columns.TargetItem
        assert restored.selected_requests == {"t": 1}
        _same_storage(restored, _jax_visuals().AppDataStorage.load(str(tmp_path / "jax")))


def test_visual_apps_construct_without_display(tmp_path: tp.Any) -> None:
    """``VisualApp`` and ``ItemToItemVisualApp`` build their storage without
    the widget packages (``display`` is not called), save and load it."""
    jax_visuals = _jax_visuals()
    app = VisualApp.construct(RECO_U2I, INTERACTIONS_SMALL, ITEM_DATA, selected_users={"u": 2}, n_random_users=1,
                              auto_display=False)
    ref = jax_visuals.VisualApp.construct(RECO_U2I, INTERACTIONS_SMALL, ITEM_DATA, selected_users={"u": 2},
                                          n_random_users=1, auto_display=False)
    _same_storage(app.data_storage, ref.data_storage)
    app.save(str(tmp_path / "u2i"))
    _same_storage(VisualApp.load(str(tmp_path / "u2i"), auto_display=False).data_storage,
                  AppDataStorage.load(str(tmp_path / "u2i")))
    reco = RECO_U2I.rename(columns={Columns.User: Columns.TargetItem})
    i2i = ItemToItemVisualApp.construct(reco, ITEM_DATA, n_random_items=2, auto_display=False)
    ref_i2i = jax_visuals.ItemToItemVisualApp.construct(reco, ITEM_DATA, n_random_items=2, auto_display=False)
    _same_storage(i2i.data_storage, ref_i2i.data_storage)
    with pytest.raises(ValueError, match="min_width"):
        VisualApp(app.data_storage, auto_display=False, min_width=5)


# ------------------------------------------------------------------ tests/test_compat_migration.py


def _jax_translate(config: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    from rectools_tpu.compat import translate_reference_config as jax_translate

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_translate(config)


class TestReferenceClassAliases:
    def test_wrapper_names_are_aliases(self) -> None:
        assert models.ImplicitALSWrapperModel is models.ALSModel
        assert models.ImplicitBPRWrapperModel is models.BPRModel
        assert models.ImplicitItemKNNWrapperModel is models.ItemKNNModel
        assert models.LightFMWrapperModel is models.HybridMFModel

    @pytest.mark.parametrize(
        "spec,expected",
        [
            ("ImplicitALSWrapperModel", "ALSModel"),
            ("rectools.models.implicit_als.ImplicitALSWrapperModel", "ALSModel"),
            ("rectools.models.ease.EASEModel", "EASEModel"),
            ("rectools.models.PopularModel", "PopularModel"),
            ("rectools.models.nn.transformers.sasrec.SASRecModel", "SASRecModel"),
        ],
    )
    def test_model_from_config_accepts_reference_cls(self, spec: str, expected: str) -> None:
        import rectools_tpu.models as jax_models

        model = model_from_config({"cls": spec, "device": "cpu"})
        assert type(model) is getattr(models, expected)
        assert type(jax_models.model_from_config({"cls": spec})).__name__ == expected

    def test_alias_config_roundtrip_uses_native_name(self) -> None:
        import rectools_tpu.models as jax_models

        model = model_from_config({"cls": "ImplicitBPRWrapperModel", "factors": 16, "device": "cpu"})
        assert model.get_config(simple_types=True)["cls"] == "BPRModel"
        ref = jax_models.model_from_config({"cls": "ImplicitBPRWrapperModel", "factors": 16})
        assert ref.get_config(simple_types=True)["cls"] == "BPRModel"


class TestTranslateReferenceConfig:
    def test_als_nested_model_flattened(self) -> None:
        ref = {
            "cls": "ImplicitALSWrapperModel",
            "model": {
                "factors": 32,
                "regularization": 0.1,
                "alpha": 5.0,
                "iterations": 3,
                "random_state": 7,
                "num_threads": 8,
                "use_gpu": True,
            },
            "fit_features_together": True,
            "recommend_n_threads": 4,
        }
        with pytest.warns(UserWarning, match="num_threads.*recommend_n_threads.*use_gpu") as record:
            cfg = translate_reference_config(ref)
        assert "in ALSModel and were dropped" in str(record[0].message)
        assert "TPU" not in str(record[0].message)
        assert cfg["cls"] == "ALSModel"
        assert (cfg["factors"], cfg["regularization"], cfg["alpha"], cfg["iterations"]) == (32, 0.1, 5.0, 3)
        assert cfg["random_state"] == 7 and cfg["fit_features_together"] is True
        assert "num_threads" not in cfg and "use_gpu" not in cfg and "device" not in cfg
        assert cfg == _jax_translate(ref)

    def test_knn_inner_cls_becomes_variant(self) -> None:
        ref = {"cls": "ImplicitItemKNNWrapperModel", "model": {"cls": "BM25Recommender", "K": 20, "K1": 1.2, "B": 0.75}}
        cfg = translate_reference_config(ref)
        assert cfg == {"cls": "ItemKNNModel", "variant": "bm25", "K": 20, "K1": 1.2, "B": 0.75} == _jax_translate(ref)

    def test_knn_default_inner_cls_is_plain(self) -> None:
        ref = {"cls": "ImplicitItemKNNWrapperModel", "model": {"K": 5}}
        assert translate_reference_config(ref) == {"cls": "ItemKNNModel", "K": 5} == _jax_translate(ref)

    def test_lightfm_outer_epochs_and_none_random_state(self) -> None:
        ref = {
            "cls": "LightFMWrapperModel",
            "model": {"no_components": 8, "loss": "warp", "random_state": None},
            "epochs": 2,
            "num_threads": 3,
        }
        with pytest.warns(UserWarning, match="num_threads"):
            cfg = translate_reference_config(ref)
        assert cfg["cls"] == "HybridMFModel"
        assert (cfg["no_components"], cfg["loss"], cfg["epochs"]) == (8, "warp", 2)
        assert "random_state" not in cfg
        assert cfg == _jax_translate(ref)

    def test_missing_cls_raises(self) -> None:
        from rectools_tpu.compat import translate_reference_config as jax_translate

        for translate in (translate_reference_config, jax_translate):
            with pytest.raises(ValueError, match="`cls` must be present"):
                translate({"model": {"factors": 4}})

    def test_translated_config_fits_and_recommends(self) -> None:
        """tests/models/data.py's dataset in each package; the port's model on
        the CPU (the translation leaves ``device`` at its default)."""
        import rectools_tpu.models as jax_models
        from rectools_tpu.dataset import Dataset as JaxDataset

        from rectools_tpu_torch.dataset import Dataset

        ref = {"cls": "ImplicitALSWrapperModel", "model": {"factors": 4, "iterations": 2, "random_state": 1}}
        cfg = translate_reference_config(ref)
        model = model_from_config({**cfg, "device": "cpu"}).fit(Dataset.construct(INTERACTIONS))
        reco = model.recommend(users=[10, 20], dataset=Dataset.construct(INTERACTIONS), k=2, filter_viewed=True)
        assert len(reco) == 4 and set(reco["user_id"]) == {10, 20}
        jax_model = jax_models.model_from_config(_jax_translate(ref)).fit(JaxDataset.construct(INTERACTIONS))
        jax_reco = jax_model.recommend(users=[10, 20], dataset=JaxDataset.construct(INTERACTIONS), k=2,
                                       filter_viewed=True)
        np.testing.assert_array_equal(reco["user_id"], jax_reco["user_id"])
        assert model.get_config(simple_types=True) == {**jax_model.get_config(simple_types=True), "device": "cpu"}


def test_requirement_placeholders() -> None:
    from rectools_tpu.compat import CatBoostRerankerUnavailable as JaxUnavailable

    for cls in (CatBoostRerankerUnavailable, JaxUnavailable):
        with pytest.raises(ImportError, match="Requirement `catboost` is not satisfied") as info:
            cls()
        assert "CatBoostRerankerUnavailable" in str(info.value)
