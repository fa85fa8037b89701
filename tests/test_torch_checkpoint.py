"""Checkpoints and serialization of the port's transformer models.

The cases of ``tests/models/nn/transformers/test_behaviors.py``'s
``TestCheckpointSurgery`` (save / load, flat config surgery, weights into a
second fitted model, the unfitted errors), parametrized over SASRec,
BERT4Rec, eSASRec (LiGR blocks, sampled softmax) and HSTU, with the
recommendations of a reloaded model held bit-equal to the original's on the
CPU. Also: ``load_model`` of ``model.save``, checkpoints that hold only CPU
tensors and load onto the loaded model's device (a checkpoint whose config
names ``cuda`` loads on a machine without one through
``model_params_update={"device": "cpu"}``), the categorical item-feature
block's coordinates, a JAX model's weights brought over by
``load_jax_params`` and reloaded (they still recommend as the JAX model does:
item ids equal, scores within rtol 1e-5 / atol 1e-4, as in
``tests/test_torch_serving.py``), and ``fit_partial`` after a reload, which
continues from the saved Adam state as the original model does (the same
bits, on one CPU thread).
"""

import io
import pickle
import typing as tp

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.dataset.context import get_context
from rectools_tpu_torch.models import (
    BERT4RecModel,
    HSTUModel,
    SASRecModel,
    load_model,
    model_from_config,
    model_from_params,
)
from rectools_tpu_torch.models.nn.item_net import CatFeaturesItemNet, IdEmbeddingsItemNet
from rectools_tpu_torch.models.nn.transformers import LiGRLayers

from .models.data import INTERACTIONS

TINY = dict(n_blocks=1, n_heads=2, n_factors=8, session_max_len=4, epochs=1, batch_size=4, seed=32,
            dropout_rate=0.0, device="cpu")
FAMILIES: tp.Dict[str, tp.Callable[..., tp.Any]] = {
    "sasrec": lambda **kw: SASRecModel(**{**TINY, **kw}),
    "bert4rec": lambda **kw: BERT4RecModel(**{**TINY, **kw}),
    "esasrec": lambda **kw: SASRecModel(
        **{**TINY, "transformer_layers_type": LiGRLayers, "loss": "sampled_softmax", "n_negatives": 3, **kw}),
    "hstu": lambda **kw: HSTUModel(**{**TINY, **kw}),
}
DATASET = Dataset.construct(INTERACTIONS)
USERS = [10, 20, 30, 40]


def _recommend(model, users=USERS, dataset: Dataset = DATASET) -> pd.DataFrame:
    context = None
    if model.require_recommend_context:
        when = pd.Timestamp("2021-12-01") + pd.to_timedelta(np.arange(len(users)), unit="h")
        context = get_context(pd.DataFrame({Columns.User: users, Columns.Item: 0, Columns.Datetime: when}))
    return model.recommend(users, dataset, k=3, filter_viewed=False, context=context)


def _assert_reco_bit_equal(got: pd.DataFrame, expected: pd.DataFrame) -> None:
    assert len(expected) > 0
    pd.testing.assert_frame_equal(got.reset_index(drop=True), expected.reset_index(drop=True), check_exact=True)


def _saved(model) -> io.BytesIO:
    buf = io.BytesIO()
    model.save_checkpoint(buf)
    buf.seek(0)
    return buf


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_from_checkpoint(family: str, tmp_path) -> None:
    model = FAMILIES[family]().fit(DATASET)
    path = tmp_path / "ckpt.pkl"
    assert model.save_checkpoint(path) > 0
    loaded = type(model).load_from_checkpoint(path)
    assert loaded.is_fitted and type(loaded) is type(model)
    _assert_reco_bit_equal(_recommend(loaded), _recommend(model))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_from_checkpoint_with_params_update(family: str, tmp_path) -> None:
    """Flat-key config surgery at load time (reference base.py:678-710)."""
    model = FAMILIES[family]().fit(DATASET)
    path = tmp_path / "ckpt.pkl"
    model.save_checkpoint(path)
    loaded = type(model).load_from_checkpoint(path, model_params_update={"recommend_batch_size": 16})
    assert loaded.recommend_batch_size == 16 and model.recommend_batch_size is None
    _assert_reco_bit_equal(_recommend(loaded), _recommend(model))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_weights_from_checkpoint(family: str, tmp_path) -> None:
    m1 = FAMILIES[family]().fit(DATASET)
    path = tmp_path / "ckpt.pkl"
    m1.save_checkpoint(path)
    m2 = FAMILIES[family](seed=99).fit(DATASET)
    assert not _recommend(m2).equals(_recommend(m1))
    m2.load_weights_from_checkpoint(path)
    _assert_reco_bit_equal(_recommend(m2), _recommend(m1))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_weights_unfitted_raises(family: str, tmp_path) -> None:
    m1 = FAMILIES[family]().fit(DATASET)
    path = tmp_path / "ckpt.pkl"
    m1.save_checkpoint(path)
    with pytest.raises(RuntimeError):
        FAMILIES[family]().load_weights_from_checkpoint(path)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_save_checkpoint_unfitted_raises(family: str, tmp_path) -> None:
    with pytest.raises(RuntimeError):
        FAMILIES[family]().save_checkpoint(tmp_path / "x.pkl")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_model_of_save(family: str, tmp_path) -> None:
    model = FAMILIES[family]().fit(DATASET)
    path = tmp_path / "model.pkl"
    model.save(path)
    loaded = load_model(path)
    assert type(loaded) is type(model)
    _assert_reco_bit_equal(_recommend(loaded), _recommend(model))
    assert loaded.get_config() == model.get_config()
    _assert_reco_bit_equal(_recommend(pickle.loads(pickle.dumps(loaded))), _recommend(model))


def test_unfitted_model_pickles_as_its_config() -> None:
    model = FAMILIES["sasrec"](n_negatives=5)
    loaded = load_model(io.BytesIO(model.dumps()))
    assert not loaded.is_fitted and loaded.get_config() == model.get_config()
    assert type(model_from_config(model.get_config())) is SASRecModel
    assert model_from_params(model.get_params(simple_types=True)).get_config() == model.get_config()


def test_load_from_checkpoint_refuses_another_class(tmp_path) -> None:
    path = tmp_path / "ckpt.pkl"
    FAMILIES["sasrec"]().fit(DATASET).save_checkpoint(path)
    with pytest.raises(TypeError):
        HSTUModel.load_from_checkpoint(path)
    with pytest.raises(TypeError):
        FAMILIES["hstu"]().fit(DATASET).load_weights_from_checkpoint(io.BytesIO(pickle.dumps({"not": "a model"})))


def _cpu_tensors(tree: tp.Any) -> tp.Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _cpu_tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _cpu_tensors(value)


def test_checkpoint_holds_only_cpu_tensors_and_loads_on_the_configs_device(monkeypatch) -> None:
    """A checkpoint of a model whose config names ``cuda`` (written here by
    setting the attribute: the tensors are the CPU's either way) loads with
    ``{"device": "cpu"}`` and recommends as the original; without the update
    it builds on ``cuda`` and raises where there is none."""
    model = FAMILIES["sasrec"]().fit(DATASET)
    state = model.training_module.get_state()
    tensors = list(_cpu_tensors(state))
    assert len(tensors) > 10 and all(t.device.type == "cpu" for t in tensors)
    assert len(state["opt_state"]["state"]) == len(list(model.backbone.parameters()))
    model.device = "cuda"
    buf = _saved(model)
    model.device = "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded = SASRecModel.load_from_checkpoint(buf, model_params_update={"device": "cpu"})
    assert loaded.device == "cpu" and next(loaded.backbone.parameters()).device.type == "cpu"
    _assert_reco_bit_equal(_recommend(loaded), _recommend(model))
    buf.seek(0)
    with pytest.raises(RuntimeError, match="cuda"):
        SASRecModel.load_from_checkpoint(buf)


def test_item_feature_block_survives_the_checkpoint() -> None:
    """CatFeaturesItemNet's CSR coordinates (not in the state_dict) travel
    in the checkpoint beside the weights."""
    rng = np.random.default_rng(4)
    items = np.unique(INTERACTIONS[Columns.Item])
    features = pd.DataFrame(
        {"id": np.repeat(items, 2), "feature": ["genre", "country"] * len(items),
         "value": [f"v{v}" for v in rng.integers(0, 3, 2 * len(items))]}
    )
    dataset = Dataset.construct(INTERACTIONS, item_features_df=features, cat_item_features=["genre", "country"])
    model = FAMILIES["sasrec"](item_net_block_types=(IdEmbeddingsItemNet, CatFeaturesItemNet)).fit(dataset)
    block = model.backbone.item_model.item_net_blocks[1]
    assert isinstance(block, CatFeaturesItemNet) and block.feature_rows.numel() > 0
    loaded = SASRecModel.load_from_checkpoint(_saved(model))
    loaded_block = loaded.backbone.item_model.item_net_blocks[1]
    for name in ("feature_rows", "feature_cols"):
        assert torch.equal(getattr(loaded_block, name), getattr(block, name))
    _assert_reco_bit_equal(_recommend(loaded, dataset=dataset), _recommend(model, dataset=dataset))


def test_jax_weights_reloaded_still_recommend_as_jax() -> None:
    rng = np.random.default_rng(11)
    n = 600
    df = pd.DataFrame(
        {
            Columns.User: rng.integers(0, 60, n),
            Columns.Item: rng.zipf(1.3, n) % 80,
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 20000, n), unit="m"),
        }
    )
    config = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=12, dropout_rate=0.2)
    jax_ds = JaxDataset.construct(df)
    jax_model = JaxSASRecModel(**config, epochs=1, batch_size=32, seed=3).fit(jax_ds)
    params = jax.tree.map(np.asarray, jax_model.training_module.params)
    dataset = Dataset.construct(df)
    port = SASRecModel(**config, device="cpu").load_jax_params(dataset, params)
    loaded = SASRecModel.load_from_checkpoint(_saved(port))
    users = np.unique(df[Columns.User])
    expected = jax_model.recommend(users, jax_ds, k=5, filter_viewed=True)
    got = loaded.recommend(users, dataset, k=5, filter_viewed=True)
    _assert_reco_bit_equal(got, port.recommend(users, dataset, k=5, filter_viewed=True))
    np.testing.assert_array_equal(got[Columns.User].to_numpy(), expected[Columns.User].to_numpy())
    np.testing.assert_allclose(got[Columns.Score].to_numpy(), expected[Columns.Score].to_numpy(), rtol=1e-5,
                               atol=1e-4)
    scores = expected[Columns.Score].to_numpy().reshape(len(users), 5)
    separated = np.ones_like(scores, dtype=bool)  # items compared where the JAX scores are not near-ties
    separated[:, 1:] &= np.abs(np.diff(scores, axis=1)) > 1e-4
    separated[:, :-1] &= np.abs(np.diff(scores, axis=1)) > 1e-4
    items = got[Columns.Item].to_numpy().reshape(len(users), 5)
    np.testing.assert_array_equal(items[separated], expected[Columns.Item].to_numpy().reshape(len(users), 5)[separated])
    assert separated.mean() > 0.8


@pytest.mark.parametrize("family", ["sasrec", "hstu"])
def test_fit_partial_after_reload_continues_from_the_saved_adam_state(family: str) -> None:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        original = FAMILIES[family](dropout_rate=0.2).fit(DATASET)
        steps = original.training_module.global_step
        loaded = type(original).load_from_checkpoint(_saved(original))
        for model in (original, loaded):
            assert model.training_module.optimizer.state_dict()["state"][0]["step"].item() == steps
            model.fit_partial(DATASET, max_epochs=1)
            assert model.training_module.global_step == 2 * steps
            assert model.training_module.epochs_completed == 2
            assert model.training_module.optimizer.state_dict()["state"][0]["step"].item() == 2 * steps
        got = dict(loaded.backbone.state_dict())
        for name, value in original.backbone.state_dict().items():
            assert torch.equal(got[name], value), name
        assert loaded.training_module.train_loss_history == original.training_module.train_loss_history
    finally:
        torch.set_num_threads(threads)
