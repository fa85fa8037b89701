"""The port's SASRec training, held against the JAX package on the CPU.

One module-scoped fixture builds a small SASRec (2 blocks, d = 32, L = 20,
about 300 items: a ragged tail against the 64-item chunk of the fused loss)
in both packages from one seeded frame, draws the JAX start parameters, and
fits the JAX model for one epoch with dropout 0 in f32. The port starts from
the same parameters (``flax_params_to_state_dict``) and must reach the same
epoch loss (1e-4 relative) and the same parameters (1e-4 absolute). The port
runs on CPU tensors: every kernel through its plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu.models.nn.transformers import sasrec as jax_sasrec
from rectools_tpu.models.nn.transformers import similarity as jax_similarity
from rectools_tpu.models.nn.transformers.negative_sampler import CatalogUniformSampler as JaxSampler
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn.transformers import (
    BestStateKeeper,
    DistanceSimilarityModule,
    EarlyStopping,
    LiGRLayers,
    SASRecDataPreparator,
    SimilarityModuleBase,
    TrainingCallback,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from rectools_tpu_torch.models.nn.transformers.negative_sampler import CatalogUniformSampler
from rectools_tpu_torch.models.nn.transformers.training import pad_batch
from rectools_tpu_torch.ops import layer_norm as layer_norm_op
from rectools_tpu_torch.ops import softmax_lse

CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5)
TRAINING_KWARGS = {"fused_softmax_chunk": 64, "val_recall_k": 5}
LR = 1e-3


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(31)
    n = 3000
    return pd.DataFrame(
        {
            Columns.User: rng.integers(0, 200, n),
            Columns.Item: rng.zipf(1.2, n) % 300,
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
        }
    )


def leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


def is_key_projection_bias(name: str) -> bool:
    """The attention key-projection biases. Softmax ignores a shift shared by
    one query's scores, so their gradient is zero in exact arithmetic: what is
    left is rounding noise, and Adam's g / (sqrt(v) + eps) turns its sign into
    a move of up to lr a step. They are the one exemption from the parameter
    checks, held to steps * lr; ``test_one_train_step_matches_jax`` shows
    that JAX's gradient for them is zero to rounding."""
    return name.endswith("multi_head_attn.k_proj.bias")


def _assert_params_close(model: SASRecModel, jax_params, atol: float, steps: int) -> None:
    """Every parameter entry within ``atol`` of JAX's, the key-projection
    biases within ``steps * lr``."""
    expected = flax_params_to_state_dict(jax_params)
    port_state = model.backbone.state_dict()
    assert set(port_state) == set(expected)
    assert sum(map(is_key_projection_bias, port_state)) == CONFIG["n_blocks"]
    for name, value in port_state.items():
        tol = steps * LR if is_key_projection_bias(name) else atol
        err = (value - expected[name]).abs().max().item()
        assert err <= tol, (name, err)


@pytest.fixture(scope="module")
def jax_run():
    df = _frame()
    model = JaxSASRecModel(
        **CONFIG, dropout_rate=0.0, get_val_mask_func=leave_last_out, training_module_kwargs=TRAINING_KWARGS
    )
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)
    # one train step on the first batch (the step donates its inputs: fresh copies)
    params, opt_state = jax.tree.map(jnp.array, start), tm._make_optimizer().init(jax.tree.map(jnp.array, start))
    stepped, _, step_loss = tm._train_step(params, opt_state, {k: jnp.asarray(v) for k, v in first.items()},
                                           jax.random.PRNGKey(0))
    one_step = (float(step_loss), jax.tree.map(np.array, stepped))
    grads = jax.grad(tm._fused_softmax_loss_value)(jax.tree.map(jnp.array, start),
                                                   {k: jnp.asarray(v) for k, v in first.items()}, None)
    tm.params, tm.opt_state = jax.tree.map(jnp.array, start), tm._make_optimizer().init(jax.tree.map(jnp.array, start))
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    return {"df": df, "start": start, "first": first, "one_step": one_step, "tm": tm,
            "grads": flax_params_to_state_dict(jax.tree.map(np.array, grads)),
            "final": jax.tree.map(np.array, tm.params)}


def _port_model(df: pd.DataFrame, start) -> SASRecModel:
    model = SASRecModel(
        **CONFIG, dropout_rate=0.0, get_val_mask_func=leave_last_out, training_module_kwargs=TRAINING_KWARGS,
        device="cpu",
    )
    model._build_model_from_dataset(Dataset.construct(df))
    model.training_module.load_params(flax_params_to_state_dict(start))
    return model


def test_one_train_step_matches_jax(jax_run) -> None:
    model = _port_model(jax_run["df"], jax_run["start"])
    tm = model.training_module
    assert tm._use_fused_softmax
    loss = tm._train_step(tm._device_batch(jax_run["first"]))
    expected_loss, expected_params = jax_run["one_step"]
    np.testing.assert_allclose(loss.item(), expected_loss, rtol=1e-5)
    _assert_params_close(model, expected_params, atol=1e-5, steps=1)
    # JAX's own gradient for the key-projection biases is rounding noise
    grads = jax_run["grads"]
    largest = max(g.abs().max().item() for g in grads.values())
    for name, grad in grads.items():
        if is_key_projection_bias(name):
            assert grad.abs().max().item() <= 1e-6 * largest, name
        elif name.endswith("bias"):
            assert grad.abs().max().item() > 1e-4 * largest, name


def test_one_epoch_fit_matches_jax(jax_run) -> None:
    model = _port_model(jax_run["df"], jax_run["start"])
    tm, jax_tm = model.training_module, jax_run["tm"]
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    assert tm.global_step == jax_tm.global_step == 7
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=1e-4)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=1e-4)
    assert tm.val_metric_history.keys() == jax_tm.val_metric_history.keys() == {"val_recall@5"}
    np.testing.assert_allclose(tm.val_metric_history["val_recall@5"], jax_tm.val_metric_history["val_recall@5"])
    _assert_params_close(model, jax_run["final"], atol=1e-4, steps=tm.global_step)


def test_one_epoch_fit_through_the_very_large_catalog_route_matches_jax(jax_run, monkeypatch) -> None:
    """With the partials budget forced to 0 every step's CE gradients take the
    route a catalog above 81,920 items takes at the KION width: the softmax
    gradients from z in the split order (kernels 13 + 14) and the label term in
    plain torch. The epoch still follows the JAX fit (1e-4)."""
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    orders = []
    twin = softmax_lse.softmax_grads_from_z_reference
    monkeypatch.setattr(softmax_lse, "softmax_grads_from_z_reference",
                        lambda *a, **k: orders.append(k["partials"]) or twin(*a, **k))
    model = _port_model(jax_run["df"], jax_run["start"])
    tm, jax_tm = model.training_module, jax_run["tm"]
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    assert orders == [False] * tm.global_step and tm.global_step == jax_tm.global_step == 7
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=1e-4)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=1e-4)
    _assert_params_close(model, jax_run["final"], atol=1e-4, steps=tm.global_step)


def test_state_dict_round_trips_through_the_flax_layout(jax_run) -> None:
    state = flax_params_to_state_dict(jax_run["start"])
    back = state_dict_to_flax_params(state)
    jax.tree.map(np.testing.assert_array_equal, back, jax_run["start"])
    model = _port_model(jax_run["df"], back)
    for name, value in model.backbone.state_dict().items():
        assert torch.equal(value, state[name])


# ------------------------------------------------------------------ batches


@pytest.mark.parametrize("with_negatives", [False, True])
def test_train_and_validation_batches_equal_jax(with_negatives: bool) -> None:
    df = _frame()
    kwargs = dict(session_max_len=20, batch_size=32, get_val_mask_func=leave_last_out)
    if with_negatives:
        jax_prep = jax_sasrec.SASRecDataPreparator(**kwargs, n_negatives=3, negative_sampler=JaxSampler(3))
        port_prep = SASRecDataPreparator(**kwargs, n_negatives=3, negative_sampler=CatalogUniformSampler(3))
    else:
        jax_prep, port_prep = jax_sasrec.SASRecDataPreparator(**kwargs), SASRecDataPreparator(**kwargs)
    jax_prep.process_dataset_train(JaxDataset.construct(df))
    port_prep.process_dataset_train(Dataset.construct(df))
    for loader in ("get_dataloader_train", "get_dataloader_val"):
        jax_rng = np.random.default_rng(np.random.SeedSequence((5, 0)))
        port_rng = np.random.default_rng(np.random.SeedSequence((5, 0)))
        jax_batches = list(getattr(jax_prep, loader)(jax_rng))
        port_batches = list(getattr(port_prep, loader)(port_rng))
        assert len(port_batches) == len(jax_batches) > 1
        for got, expected in zip(port_batches, jax_batches):
            assert got.keys() == expected.keys()
            assert ("negatives" in got) == with_negatives
            for key in got:
                np.testing.assert_array_equal(got[key], expected[key])
    padded = pad_batch(port_batches[-1], 32)
    np.testing.assert_array_equal(padded["yw"], jax_pad_batch(jax_batches[-1], 32)["yw"])


# ------------------------------------------------------------------ init, callbacks, options


def test_xavier_init_statistics() -> None:
    model = SASRecModel(n_blocks=1, n_heads=2, n_factors=128, session_max_len=50, device="cpu", seed=3)
    model._build_model_from_dataset(Dataset.construct(_frame()))
    model.training_module.init_params()
    checked = 0
    for name, param in model.backbone.named_parameters():
        if param.dim() > 1:
            fan_out, fan_in = param.shape[0], int(np.prod(param.shape[1:]))
            expected = np.sqrt(2.0 / (fan_in + fan_out))
            assert abs(param.std().item() / expected - 1) < 0.05, name
            checked += 1
    for module in model.backbone.modules():
        if isinstance(module, torch.nn.Linear):
            bound = 1 / np.sqrt(module.weight.shape[1])
            assert module.bias.abs().max().item() <= bound
            assert module.bias.abs().max().item() > 0.5 * bound
    assert checked >= 7
    # the same seed gives the same parameters
    other = SASRecModel(n_blocks=1, n_heads=2, n_factors=128, session_max_len=50, device="cpu", seed=3)
    other._build_model_from_dataset(Dataset.construct(_frame()))
    other.training_module.init_params()
    for (name, a), b in zip(model.backbone.state_dict().items(), other.backbone.state_dict().values()):
        assert torch.equal(a, b), name


class _Recorder(TrainingCallback):
    def __init__(self) -> None:
        self.states, self.logs = [], []

    def on_epoch_end(self, module, epoch, logs) -> bool:
        self.states.append({k: v.clone() for k, v in module.backbone.state_dict().items()})
        self.logs.append(dict(logs))
        return False


def _small_model(callbacks, epochs: int = 3, **kwargs) -> SASRecModel:
    return SASRecModel(n_blocks=1, n_heads=2, n_factors=16, session_max_len=10, batch_size=64, epochs=epochs,
                       dropout_rate=0.2, get_callbacks_func=lambda: callbacks or [], training_module_kwargs=kwargs,
                       device="cpu")


def test_best_state_keeper_restores_the_best_epoch() -> None:
    recorder = _Recorder()
    keeper = BestStateKeeper(monitor="train_loss", mode="max")  # epoch 1 has the highest loss
    model = _small_model([recorder, keeper]).fit(Dataset.construct(_frame()))
    losses = model.training_module.train_loss_history
    assert len(losses) == 3 and losses[0] > losses[-1]
    assert keeper.best_epoch == 1
    for name, value in model.backbone.state_dict().items():
        assert torch.equal(value, recorder.states[0][name]), name


def test_early_stopping_stops_after_patience() -> None:
    stopper = EarlyStopping(monitor="train_loss", mode="max", patience=1)
    model = _small_model([stopper], epochs=5).fit(Dataset.construct(_frame()))
    assert stopper.stopped_epoch == 2
    assert len(model.training_module.train_loss_history) == 2
    with pytest.warns(UserWarning, match="not in epoch logs"):
        assert not EarlyStopping(monitor="val_loss").on_epoch_end(None, 1, {"train_loss": 1.0})


def test_fit_then_recommend_end_to_end() -> None:
    df = _frame()
    dataset = Dataset.construct(df)
    model = SASRecModel(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=64, epochs=2,
                        get_val_mask_func=leave_last_out, training_module_kwargs={"val_recall_k": 10}, device="cpu")
    model.fit(dataset)
    tm = model.training_module
    assert len(tm.train_loss_history) == 2 and tm.train_loss_history[1] < tm.train_loss_history[0]
    assert np.isfinite(tm.val_loss_history).all() and len(tm.val_metric_history["val_recall@10"]) == 2
    users = np.unique(df[Columns.User])[:30]
    reco = model.recommend(users, dataset, k=5, filter_viewed=True)
    assert len(reco) == 5 * len(users)
    seen = set(zip(df[Columns.User], df[Columns.Item]))
    assert not any(pair in seen for pair in zip(reco[Columns.User], reco[Columns.Item]))
    assert np.isfinite(reco[Columns.Score]).all()
    # fit_partial continues the same stream of epochs
    model.fit_partial(dataset, max_epochs=1)
    assert tm.epochs_completed == 3 and len(tm.train_loss_history) == 3
    # the config carries the training options across
    config = model.get_config()
    assert config["training_module_kwargs"] == {"val_recall_k": 10}
    assert SASRecModel.from_config(config).training_module_kwargs == {"val_recall_k": 10}


@pytest.mark.parametrize("loss", ["BCE", "gBCE", "sampled_softmax"])
def test_sampled_losses_fit(loss: str) -> None:
    model = SASRecModel(n_blocks=1, n_heads=2, n_factors=16, session_max_len=10, batch_size=64, epochs=2, loss=loss,
                        n_negatives=4, device="cpu")
    model.fit(Dataset.construct(_frame()))
    losses = model.training_module.train_loss_history
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert not model.data_preparator.host_negatives  # drawn on the device with the counter hash


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"mesh_shape": (2, 1)}, "multi-device"),
        ({"compute_dtype": "bfloat16"}, "bf16"),
        ({"steps_per_dispatch": 0}, "steps_per_dispatch"),
    ],
)
def test_unported_training_options_raise(kwargs, match: str) -> None:
    # bf16 is ported: this model's heads of 8 (16 / 2 heads) raised until their bf16 forms existed
    if "compute_dtype" in kwargs:
        model = _small_model(None, **kwargs).fit(Dataset.construct(_frame()))
        assert model.training_module.resolved_compute_dtype == "bfloat16"
        assert np.isfinite(model.training_module.train_loss_history).all()
        return
    # a mesh needs a world of n_data * n_model processes: one process has none
    with pytest.raises(ValueError, match=match):
        _small_model(None, **kwargs).fit(Dataset.construct(_frame()))


# ------------------------------------------------------------------ shared negatives and remat


class _SubclassedSampler(CatalogUniformSampler):
    """Any sampler but the default one keeps its negatives on the host."""


class _TowerlessSimilarity(DistanceSimilarityModule):
    """A similarity module that does not override ``catalog_loss_towers``."""

    catalog_loss_towers = SimilarityModuleBase.catalog_loss_towers


@pytest.mark.parametrize(
    "case,match",
    [
        ("not_on_device", "negatives_on_device=True"),
        ("custom_sampler", "device-drawn negatives"),
        ("towerless_similarity", "catalog_loss_towers"),
        ("unknown_sharing", "'positionwise' or 'batch'"),
    ],
)
def test_shared_negative_options_raise_as_in_jax(case: str, match: str) -> None:
    """The JAX package's errors for ``negatives_sharing`` (its
    test_behaviors.py ``TestSharedNegatives`` and training.py checks), raised
    by both packages for the same configuration."""
    kwargs = {"negatives_sharing": "nope" if case == "unknown_sharing" else "batch"}
    model_kwargs: dict = {}
    if case == "not_on_device":
        kwargs["negatives_on_device"] = False
    if case == "custom_sampler":
        model_kwargs["negative_sampler_type"] = _SubclassedSampler
    if case == "towerless_similarity":
        model_kwargs["similarity_module_type"] = _TowerlessSimilarity
        jax_kwargs = {"similarity_module_type": type("JaxTowerless", (jax_similarity.DistanceSimilarityModule,), {
            "catalog_loss_towers": jax_similarity.SimilarityModuleBase.catalog_loss_towers})}
    else:
        jax_kwargs = {"negative_sampler_type": type("JaxSub", (JaxSampler,), {})} if case == "custom_sampler" else {}
    config = dict(n_blocks=1, n_heads=2, n_factors=16, session_max_len=10, batch_size=64, epochs=1,
                  loss="sampled_softmax", n_negatives=4, training_module_kwargs=kwargs)
    with pytest.raises(ValueError, match=match):
        JaxSASRecModel(**config, **jax_kwargs).fit(JaxDataset.construct(_frame()))
    with pytest.raises(ValueError, match=match):
        SASRecModel(**config, **model_kwargs, device="cpu").fit(Dataset.construct(_frame()))


FAMILIES = {
    "sasrec": (SASRecModel, {}),
    "ligr": (SASRecModel, {"transformer_layers_type": LiGRLayers}),
    "hstu": (HSTUModel, {}),
}
ROUTES = {
    "fused_softmax": ({"loss": "softmax"}, {"fused_softmax_chunk": 64}),
    "positionwise": ({"loss": "sampled_softmax", "n_negatives": 8}, {}),
    "shared": ({"loss": "sampled_softmax", "n_negatives": 8}, {"negatives_sharing": "batch"}),
}


@pytest.fixture
def one_thread():
    """One CPU thread: torch's threaded scatter-add on the CPU (the backward of
    the candidates' embedding gather) sums duplicate rows in a thread-dependent
    order, so two runs of one fit part by rounding, which Adam turns into moves
    of up to lr on the key-projection biases. With one thread a fit gives the
    same bits on every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_matches_plain_training(family: str, route: str, monkeypatch: pytest.MonkeyPatch, one_thread) -> None:
    """``remat=True`` recomputes the forward in the backward (the LayerNorm
    forward runs more often in training) and, at dropout 0.2, follows the
    plain fit: the recompute draws the forward's dropout salts, so losses,
    validation losses and parameters after an epoch agree within 1e-6 (the
    JAX package's test_transformers.py ``test_remat_matches_plain_training``
    and ``test_remat_with_fused_softmax_chunking``)."""
    model_cls, family_kwargs = FAMILIES[family]
    loss_kwargs, training_kwargs = ROUTES[route]
    dataset = Dataset.construct(_frame())
    calls = {"ln": 0}
    twin = layer_norm_op.layer_norm_reference
    monkeypatch.setattr(layer_norm_op, "layer_norm_reference", lambda *a: calls.__setitem__("ln", calls["ln"] + 1)
                        or twin(*a))
    runs = {}
    for remat in (False, True):
        calls["ln"] = 0
        model = model_cls(**CONFIG, **family_kwargs, **loss_kwargs, dropout_rate=0.2, get_val_mask_func=leave_last_out,
                          training_module_kwargs={**training_kwargs, "remat": remat}, device="cpu")
        model.fit(dataset)
        runs[remat] = (model, calls["ln"])
    (plain, plain_ln), (remat, remat_ln) = runs[False], runs[True]
    tm, plain_tm = remat.training_module, plain.training_module
    assert tm._use_fused_softmax == (route == "fused_softmax") and tm._shares_negatives == (route == "shared")
    assert remat_ln > plain_ln > 0  # the recompute ran the encoder's LayerNorms again
    np.testing.assert_allclose(tm.train_loss_history, plain_tm.train_loss_history, rtol=1e-6)
    np.testing.assert_allclose(tm.val_loss_history, plain_tm.val_loss_history, rtol=1e-6)
    plain_state = plain.backbone.state_dict()
    for name, value in remat.backbone.state_dict().items():
        assert (value - plain_state[name]).abs().max().item() <= 1e-6, name

