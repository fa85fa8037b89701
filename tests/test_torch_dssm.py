"""The port's DSSM (towers, triplet loss, training, serving) and its data
builders held against the JAX package's on the CPU, on a seeded 300-user
frame with user and item features (and tests/models/data.py's dataset).

Tolerances:
- the towers' outputs from the same flax parameters within 1e-6 of the
  largest entry; the triplet loss within 1e-6 relative and its gradients
  within 1e-6 of the largest entry;
- optax's ``chain(add_decayed_weights, adam)`` against
  ``torch.optim.Adam(weight_decay=...)``: 3 steps within 1e-6 of the
  largest parameter;
- a fit from JAX's initial parameters on the same (bit-equal) batches: the
  epoch losses within 1e-5 relative, every weight within 1e-4 (Adam divides
  by the root of a second moment, so a gradient entry near 0 moves its
  weight by the sign of rounding noise);
- the batch builders bit-equal;
- served from JAX's fitted parameters (``load_jax_dssm_params``): identical
  items and ranks (u2i hot and warm, i2i), squared EUCLIDEAN distances
  within 1e-6 of the largest squared vector norm (the cancellation of
  |s|^2 + |o|^2 - 2 s.o; a reload, bit-equal);
- the port's own initial weights: inside flax's truncation at two standard
  deviations, with its standard deviation within 5%; a refit repeats bit
  for bit.
"""

import pickle
import typing as tp

import numpy as np
import pandas as pd
import pytest
import torch

import rectools_tpu_torch.models.nn.dssm as port_dssm
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.dataset.dssm_datasets import DSSMItemDataset, DSSMTrainDataset, DSSMUserDataset
from rectools_tpu_torch.models import DSSMModel, model_from_config
from rectools_tpu_torch.models.convert import jax_dssm_params, load_jax_dssm_params

from .models.data import INTERACTIONS

WARM_USER = 10**6 + 1  # a user with features and no interactions
N_FACTORS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small steps; other test workers hold the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _interactions(frame: str) -> pd.DataFrame:
    if frame == "tiny":
        return INTERACTIONS
    rng = np.random.default_rng(18)
    n = 3000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 300, n),
        Columns.Item: (rng.zipf(1.3, n) * 7) % 120,
        Columns.Weight: rng.integers(1, 6, n).astype(float),
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    })
    return df.drop_duplicates([Columns.User, Columns.Item]).astype({Columns.Datetime: "datetime64[ns]"})


def _datasets(frame: str = "seeded") -> tp.Tuple[tp.Any, tp.Any]:
    """(the port's Dataset, the JAX package's): two categorical user features
    (every user and WARM_USER), a categorical and a direct item feature (a
    random value an item: no two items share a vector or sit at tied
    distances from a third, so EUCLIDEAN scores do not tie)."""
    from rectools_tpu.dataset import Dataset as JaxDataset

    df = _interactions(frame)
    users = np.append(np.unique(df[Columns.User]), WARM_USER)
    items = np.unique(df[Columns.Item])
    kwargs = dict(
        user_features_df=pd.concat([pd.DataFrame({"id": users, "feature": "age", "value": users % 6}),
                                    pd.DataFrame({"id": users, "feature": "sex", "value": users % 2})]),
        cat_user_features=["age", "sex"],
        item_features_df=pd.concat([pd.DataFrame({"id": items, "feature": "genre", "value": items % 4}),
                                    pd.DataFrame({"id": items, "feature": "length", "value": np.random.default_rng(23).random(len(items))})]),
        cat_item_features=["genre"],
    )
    return Dataset.construct(df, **kwargs), JaxDataset.construct(df, **kwargs)


def _models(**kwargs: tp.Any) -> tp.Tuple[DSSMModel, tp.Any]:
    from rectools_tpu.models import DSSMModel as JaxDSSMModel

    kwargs = {"n_factors": N_FACTORS, "max_epochs": 1, "batch_size": 128, "random_state": 0, **kwargs}
    return DSSMModel(**kwargs, device="cpu"), JaxDSSMModel(**kwargs)


def _jax_init(jax_dataset: tp.Any, random_state: int) -> dict:
    """JAX's initial flax parameters of a fit (its ``towers.init`` on its sample)."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.dataset.dssm_datasets import DSSMTrainDataset as JaxTrainDataset
    from rectools_tpu.models.nn.dssm import DSSMTowers as JaxTowers

    sample = JaxTrainDataset.from_dataset(jax_dataset).make_batch(np.arange(2), np.random.default_rng(random_state))
    params = JaxTowers(n_factors=N_FACTORS).init(jax.random.PRNGKey(random_state), *(jnp.asarray(x) for x in sample))
    return jax.tree.map(np.asarray, params["params"])


def _port_towers(flax_params: dict) -> port_dssm.DSSMTowers:
    return load_jax_dssm_params(DSSMModel(n_factors=N_FACTORS, device="cpu"), flax_params).towers


def _assert_reco_equal(got: pd.DataFrame, expected: pd.DataFrame, norm_sq: tp.Optional[float] = None) -> None:
    """Identical rows; scores within 1e-5 relative, or, for EUCLIDEAN
    distances (``norm_sq``: the largest squared vector norm), squared
    distances within 1e-6 * norm_sq: |s|^2 + |o|^2 - 2 s.o cancels there."""
    got, expected = got.reset_index(drop=True), expected.reset_index(drop=True)
    assert list(got.columns) == list(expected.columns) and len(got) == len(expected) > 0
    for column in got.columns:
        if column == Columns.Score and norm_sq is not None:
            np.testing.assert_allclose(got[column].to_numpy() ** 2, expected[column].to_numpy() ** 2, rtol=0,
                                       atol=1e-6 * norm_sq)
        elif column == Columns.Score:
            np.testing.assert_allclose(got[column].to_numpy(), expected[column].to_numpy(), rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[column].to_numpy(), expected[column].to_numpy(), err_msg=column)


# ------------------------------------------------------------------ towers, loss, Adam


def test_towers_match_flax() -> None:
    import jax.numpy as jnp

    from rectools_tpu.models.nn.dssm import DSSMTowers as JaxTowers

    dataset, jax_dataset = _datasets()
    params = _jax_init(jax_dataset, 3)
    towers = _port_towers(params)
    rng = np.random.default_rng(19)
    uf, inter, pos, neg = DSSMTrainDataset.from_dataset(dataset).make_batch(np.arange(40), rng)
    expected = JaxTowers(n_factors=N_FACTORS).apply({"params": params}, *(jnp.asarray(x) for x in (uf, inter, pos, neg)))
    with torch.no_grad():
        got = towers(*(torch.from_numpy(x) for x in (uf, inter, pos, neg)))
    for a, b in zip(got, expected):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * np.abs(b).max())


def test_triplet_margin_loss_and_its_gradient_match_jax() -> None:
    import jax
    import jax.numpy as jnp

    from rectools_tpu.models.nn.dssm import triplet_margin_loss as jax_loss

    rng = np.random.default_rng(20)
    a, p, n = (rng.normal(size=(32, 8)).astype(np.float32) for _ in range(3))
    p[0] = a[0]  # a zero distance: the eps inside the root keeps its gradient finite
    mask = np.r_[np.ones(28), np.zeros(4)].astype(np.float32)
    expected, expected_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), 0.4, jnp.asarray(mask))
    tensors = [torch.from_numpy(x).requires_grad_(True) for x in (a, p, n)]
    got = port_dssm.triplet_margin_loss(*tensors, 0.4, torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(expected), rtol=1e-6)
    for t, g in zip(tensors, expected_grads):
        g = np.asarray(g)
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-6 * np.abs(g).max())


def test_torch_adam_with_weight_decay_is_optax_chain() -> None:
    """optax ``chain(add_decayed_weights(wd), adam(lr))`` and
    ``torch.optim.Adam(lr, weight_decay=wd)``: three steps on the same
    gradients give the same parameters."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(21)
    start = rng.normal(size=(50, 6)).astype(np.float32)
    grads = [(rng.normal(size=(50, 6)) * 10.0 ** rng.integers(-6, 1, (50, 6))).astype(np.float32) for _ in range(3)]
    tx = optax.chain(optax.add_decayed_weights(1e-2), optax.adam(0.01))
    params = jnp.asarray(start)
    state = tx.init(params)
    weight = torch.nn.Parameter(torch.from_numpy(start.copy()))
    adam = torch.optim.Adam([weight], lr=0.01, weight_decay=1e-2)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        weight.grad = torch.from_numpy(g.copy())
        adam.step()
    np.testing.assert_allclose(weight.detach().numpy(), np.asarray(params), rtol=0, atol=1e-6 * np.abs(start).max())


@pytest.mark.parametrize("epochs", [1, 2])
def test_fit_from_jax_init_matches_jax(epochs: int, monkeypatch: pytest.MonkeyPatch) -> None:
    """A fit from JAX's initial parameters: 3 Adam steps an epoch on
    bit-equal batches (the same numpy draws), then the same parameters,
    losses and recommendations."""
    dataset, jax_dataset = _datasets()
    init = _jax_init(jax_dataset, 0)

    def jax_init(towers: port_dssm.DSSMTowers, generator: torch.Generator) -> port_dssm.DSSMTowers:
        towers.load_state_dict(_port_towers(init).state_dict())
        return towers

    monkeypatch.setattr(port_dssm, "init_towers", jax_init)
    port, jax_model = _models(max_epochs=epochs)
    assert len(DSSMTrainDataset.from_dataset(dataset)) == 300  # 3 batches of 128, the last one masked
    port.fit(dataset)
    jax_model.fit(jax_dataset)
    np.testing.assert_allclose(port.train_loss_history, jax_model.train_loss_history, rtol=1e-5)
    expected = _port_towers(jax_model.params).state_dict()
    for name, weight in port.towers.state_dict().items():
        np.testing.assert_allclose(weight.numpy(), expected[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
    for got, ref in zip(port.get_vectors(dataset), jax_model.get_vectors(jax_dataset)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


# ------------------------------------------------------------------ data builders


def test_batch_builders_match_jax() -> None:
    from rectools_tpu.dataset import dssm_datasets as jax_datasets

    dataset, jax_dataset = _datasets()
    train, jax_train = DSSMTrainDataset.from_dataset(dataset), jax_datasets.DSSMTrainDataset.from_dataset(jax_dataset)
    rows = np.random.default_rng(22).integers(0, len(train), 64)
    for got, expected in zip(train.make_batch(rows, np.random.default_rng(5)),
                             jax_train.make_batch(rows, np.random.default_rng(5))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, expected)
    users, jax_users = DSSMUserDataset.from_dataset(dataset), jax_datasets.DSSMUserDataset.from_dataset(jax_dataset)
    items, jax_items = DSSMItemDataset.from_dataset(dataset), jax_datasets.DSSMItemDataset.from_dataset(jax_dataset)
    assert len(users) == len(jax_users) == dataset.user_id_map.size and len(items) == len(jax_items)
    for got, expected in zip(users.dense_rows(np.arange(len(users))), jax_users.dense_rows(np.arange(len(users)))):
        np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(items.dense_rows(np.arange(len(items))), jax_items.dense_rows(np.arange(len(items))))
    kept = DSSMUserDataset.from_dataset(dataset, keep_users=[0, 2])
    np.testing.assert_array_equal(kept.dense_rows(np.arange(2))[0], users.dense_rows(np.array([0, 2]))[0])


def test_positives_are_weight_proportional() -> None:
    """Positives come from the row's items in proportion to their weights:
    4,000 draws of one row against its weights (chi-square at 0.1%)."""
    from scipy import sparse, stats

    interactions = sparse.csr_matrix(np.array([[1.0, 0.0, 3.0, 6.0], [0.0, 2.0, 0.0, 0.0]], np.float32))
    train = DSSMTrainDataset(sparse.identity(4, format="csr"), sparse.identity(2, format="csr"), interactions)
    drawn = train.sample_positives(np.zeros(4000, dtype=np.int64), np.random.default_rng(6))
    counts = np.bincount(drawn, minlength=4)
    assert counts[1] == 0
    assert stats.chisquare(counts[[0, 2, 3]], 4000 * np.array([0.1, 0.3, 0.6])).statistic < stats.chi2.ppf(0.999, 2)
    assert (train.sample_positives(np.ones(10, dtype=np.int64), np.random.default_rng(7)) == 1).all()


def test_builders_refuse_bad_input() -> None:
    from scipy import sparse

    with pytest.raises(ValueError, match="at least 1 positive"):
        DSSMTrainDataset(sparse.identity(2, format="csr"), sparse.identity(2, format="csr"),
                         sparse.csr_matrix(np.array([[1.0, 0.0], [0.0, 0.0]], np.float32)))
    with pytest.raises(ValueError, match="same"):
        DSSMUserDataset(sparse.identity(3, format="csr"), sparse.identity(2, format="csr"))
    with pytest.raises(AttributeError):
        DSSMItemDataset.from_dataset(Dataset.construct(INTERACTIONS))
    with pytest.raises(ValueError, match="requires user and item features"):
        DSSMModel(device="cpu").fit(Dataset.construct(INTERACTIONS))


# ------------------------------------------------------------------ serving, pickles, configs


def test_serving_from_jax_params_matches_jax() -> None:
    """EUCLIDEAN u2i for hot and warm users, and i2i, from JAX's fitted
    parameters: the port's items are JAX's."""
    dataset, jax_dataset = _datasets()
    port, jax_model = _models(max_epochs=2)
    jax_model.fit(jax_dataset)
    load_jax_dssm_params(port, jax_model.params)
    users = np.unique(_interactions("seeded")[Columns.User])
    items = np.unique(_interactions("seeded")[Columns.Item])
    calls = [
        ("recommend", dict(users=users, k=5, filter_viewed=True)),
        ("recommend", dict(users=np.append(users[:7], WARM_USER), k=4, filter_viewed=False)),
        ("recommend", dict(users=users, k=3, filter_viewed=True, items_to_recommend=items[::3])),
        ("recommend_to_items", dict(target_items=items, k=3)),
    ]
    norm_sq = max(float((v**2).sum(axis=1).max()) for v in port.get_vectors(dataset))
    for method, kwargs in calls:
        _assert_reco_equal(getattr(port, method)(dataset=dataset, **kwargs),
                           getattr(jax_model, method)(dataset=jax_dataset, **kwargs), norm_sq)
    warm = port.recommend([WARM_USER], dataset, 4, filter_viewed=False)
    assert list(warm[Columns.User]) == [WARM_USER] * 4


def test_load_jax_dssm_params_checks_the_tree() -> None:
    _, jax_dataset = _datasets()
    params = _jax_init(jax_dataset, 0)
    with pytest.raises(ValueError, match="load_fitted_arrays"):
        load_jax_dssm_params(DSSMModel(n_factors=N_FACTORS + 1, device="cpu"), params)
    broken = {net: dict(layers) for net, layers in params.items()}
    broken["item_net"].pop("dense_layer")
    with pytest.raises(ValueError, match="load_fitted_arrays"):
        load_jax_dssm_params(DSSMModel(n_factors=N_FACTORS, device="cpu"), broken)
    model = load_jax_dssm_params(DSSMModel(n_factors=N_FACTORS, device="cpu"), params)
    assert model.is_fitted
    np.testing.assert_array_equal(model.towers.user_net.output_layer.weight.detach().numpy(),
                                  params["user_net"]["output_layer"]["kernel"].T)
    back = jax_dssm_params(model)  # the inverse, as a CPU copy of a fitted model is made
    assert back.keys() == params.keys()
    for net, layers in params.items():
        assert back[net].keys() == layers.keys()
        for layer, leaves in layers.items():
            np.testing.assert_array_equal(back[net][layer]["kernel"], leaves["kernel"])


def test_pickle_holds_cpu_tensors_and_reloads_on_the_config_device() -> None:
    dataset, _ = _datasets()
    model, _ = _models(max_epochs=1)
    model.fit(dataset)
    state = model.__getstate__()
    assert "_towers" not in state and all(t.device.type == "cpu" for t in state["_tower_weights"].values())
    restored = pickle.loads(pickle.dumps(model))
    assert restored.towers is not model.towers
    for name, weight in model.towers.state_dict().items():
        assert torch.equal(restored.towers.state_dict()[name], weight)
    users = dataset.user_id_map.external_ids[:50]
    pd.testing.assert_frame_equal(restored.recommend(users, dataset, 5, True), model.recommend(users, dataset, 5, True))
    unfitted = pickle.loads(pickle.dumps(DSSMModel(device="cpu")))
    assert unfitted._towers is None and not unfitted.is_fitted


def test_config_round_trip_and_jax_config() -> None:
    port, jax_model = _models(n_factors=16, lr=0.02)
    config = port.get_config()
    assert config["device"] == "cpu" and config["cls"] is DSSMModel
    assert DSSMModel.from_config(config).get_config() == config
    assert model_from_config(port.get_config(simple_types=True)).get_config() == config
    jax_config = jax_model.get_config(simple_types=True)
    loaded = model_from_config({**jax_config, "device": "cpu"})
    assert type(loaded) is DSSMModel
    assert {k: v for k, v in loaded.get_config(simple_types=True).items() if k != "device"} == jax_config


def test_default_device_is_the_card() -> None:
    if torch.cuda.is_available():
        assert DSSMModel().get_config()["device"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            DSSMModel()


# ------------------------------------------------------------------ the port's own draws


def test_own_initial_weights_follow_flax_lecun_normal() -> None:
    towers = port_dssm.init_towers(port_dssm.DSSMTowers(300, 400, 200, 64), torch.Generator().manual_seed(0))
    for name, weight in towers.state_dict().items():
        std = np.sqrt(1.0 / weight.shape[1])  # lecun_normal: variance 1 / fan_in after the truncation
        w = weight.numpy()
        assert np.abs(w).max() <= 2 * std / port_dssm._TRUNCATED_NORMAL_STD + 1e-7, name
        assert abs(w.std() / std - 1.0) < 0.05 and abs(w.mean()) < 0.05 * std, name


def test_refit_from_the_seed_repeats_bit_for_bit_and_the_loss_falls() -> None:
    dataset, _ = _datasets()
    first, _ = _models(max_epochs=4, batch_size=32)
    second, _ = _models(max_epochs=4, batch_size=32)
    first.fit(dataset)
    second.fit(dataset)
    for name, weight in first.towers.state_dict().items():
        assert torch.equal(second.towers.state_dict()[name], weight), name
    assert first.train_loss_history == second.train_loss_history
    assert first.train_loss_history[-1] < first.train_loss_history[0]
    other, _ = _models(max_epochs=1, batch_size=32, random_state=1)
    other.fit(dataset)
    assert not torch.equal(other.towers.item_net.output_layer.weight, first.towers.item_net.output_layer.weight)
