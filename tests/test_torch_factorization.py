"""The port's factorization models (ALS, BPR, HybridMF) and their ops held
against the JAX package's on the CPU, on tests/models/data.py's dataset
("tiny") and on a seeded 300-user frame with user and item features
("seeded").

Tolerances (absolute, f32 products summed in another order):
- ALS: ``_solve_batch`` and ``als_half_step`` within 1e-5 of the largest
  entry; ``als_fit`` and the models after 3 iterations within 1e-4 of it;
  the bucket packing equal; a system whose Cholesky fails is a NaN row in
  both packages.
- BPR on JAX's injected permutations and negatives: 5 epochs within 1e-6.
- HybridMF ``train_step`` on JAX's initial tables and negatives: losses
  within 1e-6 relative, the tables within 1e-6 after 3 steps; the model's
  fits (batches bit-equal by construction) within 1e-5.
- Served from JAX's fitted arrays (``models/convert.py``): identical items
  and ranks (u2i, i2i, warm, cold), scores within 1e-5 relative.
- The port's own draws: properties (a permutation, the range, the mean and
  a chi-square bound at 0.1%), and a refit repeats bit for bit.
"""

import pickle
import typing as tp

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse, stats

import rectools_tpu_torch.ops.bpr as port_bpr_ops
import rectools_tpu_torch.ops.hybrid_mf as port_hmf_ops
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import (
    ALSModel,
    BPRModel,
    HybridMFModel,
    ImplicitALSWrapperModel,
    ImplicitBPRWrapperModel,
    LightFMWrapperModel,
    model_from_config,
)
from rectools_tpu_torch.models.convert import fitted_arrays, load_fitted_arrays
from rectools_tpu_torch.ops import als as port_als_ops

from .models.data import INTERACTIONS

FRAMES = ("tiny", "seeded")
COLD_USER = 10**6  # an external id no frame holds
WARM_USER = 10**6 + 1  # a user with features and no interactions
# name: (port class, its keyword arguments); the JAX class has the same name
MODELS = {
    "als": (ALSModel, {"factors": 4, "iterations": 3, "random_state": 32, "regularization": 0.1}),
    "als_together": (ALSModel, {"factors": 4, "iterations": 3, "random_state": 32, "regularization": 0.1,
                                "fit_features_together": True}),
    "bpr": (BPRModel, {"factors": 8, "iterations": 5, "random_state": 3, "learning_rate": 0.05, "batch_size": 128}),
    "hybrid_warp": (HybridMFModel, {"no_components": 8, "loss": "warp", "epochs": 2, "batch_size": 256}),
    "hybrid_kos": (HybridMFModel, {"no_components": 8, "loss": "warp-kos", "k": 2, "n": 4, "epochs": 2,
                                   "batch_size": 256, "learning_schedule": "adadelta", "learning_rate": 1.0}),
    "hybrid_logistic": (HybridMFModel, {"no_components": 8, "loss": "logistic", "epochs": 2, "batch_size": 256,
                                        "user_alpha": 0.01, "item_alpha": 0.01}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: its steps are hundreds of small ops,
    and with other test workers holding the cores each parallel region
    waits for its slowest thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _interactions(frame: str) -> pd.DataFrame:
    if frame == "tiny":
        return INTERACTIONS
    rng = np.random.default_rng(17)
    n = 3000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 300, n),
        Columns.Item: (rng.zipf(1.3, n) * 7) % 120,
        Columns.Weight: rng.integers(1, 6, n).astype(float),
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    })
    return df.drop_duplicates([Columns.User, Columns.Item]).astype({Columns.Datetime: "datetime64[ns]"})


def _features(df: pd.DataFrame) -> dict:
    """Two categorical user features (for every user and WARM_USER, who has
    no interactions) and one categorical plus one direct item feature."""
    users = np.append(np.unique(df[Columns.User]), WARM_USER)
    items = np.unique(df[Columns.Item])
    user_features = pd.concat([
        pd.DataFrame({"id": users, "feature": "age", "value": users % 6}),
        pd.DataFrame({"id": users, "feature": "sex", "value": users % 2}),
    ])
    item_features = pd.concat([
        pd.DataFrame({"id": items, "feature": "genre", "value": items % 4}),
        pd.DataFrame({"id": items, "feature": "length", "value": (items % 7) / 7.0}),
    ])
    return dict(user_features_df=user_features, cat_user_features=["age", "sex"],
                item_features_df=item_features, cat_item_features=["genre"])


def _datasets(frame: str, features: bool = True) -> tp.Tuple[tp.Any, tp.Any]:
    """(the port's Dataset, the JAX package's) from the same frames."""
    from rectools_tpu.dataset import Dataset as JaxDataset

    df = _interactions(frame)
    kwargs = _features(df) if features else {}
    return Dataset.construct(df, **kwargs), JaxDataset.construct(df, **kwargs)


def _models(name: str, **overrides: tp.Any) -> tp.Tuple[tp.Any, tp.Any]:
    import rectools_tpu.models as jax_models

    cls, kwargs = MODELS[name]
    kwargs = {**kwargs, **overrides}
    return cls(**kwargs, device="cpu"), getattr(jax_models, cls.__name__)(**kwargs)


def _assert_reco_equal(got: pd.DataFrame, expected: pd.DataFrame) -> None:
    got, expected = got.reset_index(drop=True), expected.reset_index(drop=True)
    assert list(got.columns) == list(expected.columns)
    assert len(got) == len(expected)
    for column in got.columns:
        if column == Columns.Score:
            np.testing.assert_allclose(got[column].to_numpy(), expected[column].to_numpy(), rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(got[column].to_numpy(), expected[column].to_numpy(), err_msg=column)


def _close(got: np.ndarray, expected: np.ndarray, scale: float) -> None:
    np.testing.assert_allclose(got, expected, rtol=0, atol=scale * max(float(np.abs(expected).max()), 1e-30))


# ------------------------------------------------------------------ JAX's draws, injected


def _jax_bpr_draws(random_state: tp.Optional[int], n_items: int) -> port_bpr_ops.EpochDraw:
    """JAX ``bpr_fit``'s keys: each epoch's permutation and negatives, as
    ``_bpr_epoch`` draws them."""
    import jax
    import jax.numpy as jnp

    state = {"key": jax.random.PRNGKey(random_state if random_state is not None else 0)}

    def draw(epoch: int, nnz: int, n_batches: int, batch_size: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        state["key"], sub = jax.random.split(state["key"])
        perm_key, neg_key = jax.random.split(sub)
        perm = jax.random.permutation(perm_key, nnz)
        negs = jax.random.randint(neg_key, (n_batches, batch_size), 0, n_items, dtype=jnp.int32)
        return torch.from_numpy(np.array(perm)), torch.from_numpy(np.array(negs))

    return draw


def _jax_negatives(random_state: int, n_items: int, max_sampled: int) -> port_hmf_ops.NegativeDraw:
    """HybridMF's negatives as JAX's ``train_step`` draws them under
    ``fold_in(PRNGKey(random_state + 17), step)``."""
    import jax

    key = jax.random.PRNGKey(random_state + 17)

    def draw(step: int, batch_size: int) -> torch.Tensor:
        neg = jax.random.randint(jax.random.fold_in(key, step), (batch_size, max_sampled), 0, n_items)
        return torch.from_numpy(np.array(neg)).long()

    return draw


def _inject_jax_hybrid_draws(monkeypatch: pytest.MonkeyPatch, random_state: int) -> None:
    """The port's HybridMF starts from JAX's initial tables and draws JAX's negatives."""
    from rectools_tpu.ops.hybrid_mf import init_params as jax_init_params

    def init_params(n_uf: int, n_if: int, d: int, generator: torch.Generator) -> dict:
        return {k: torch.from_numpy(np.array(v)) for k, v in jax_init_params(n_uf, n_if, d, random_state).items()}

    monkeypatch.setattr(port_hmf_ops, "init_params", init_params)
    monkeypatch.setattr(port_hmf_ops, "negative_draws",
                        lambda generator, n_items, max_sampled: _jax_negatives(random_state, n_items, max_sampled))


def _inject_jax_draws(name: str, monkeypatch: pytest.MonkeyPatch) -> None:
    kwargs = MODELS[name][1]
    if name == "bpr":
        monkeypatch.setattr(port_bpr_ops, "generator_draws",
                            lambda generator, n_items: _jax_bpr_draws(kwargs["random_state"], n_items))
    elif name.startswith("hybrid"):
        _inject_jax_hybrid_draws(monkeypatch, kwargs.get("random_state", 0))


# ------------------------------------------------------------------ ALS ops


def _als_case(case: str) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """(y, idx, conf, regularization) of a small bucket: positive
    confidences, confidences below 1 and negative ones, or a singular Gram
    (a zero column and no regularization)."""
    rng = np.random.default_rng(5)
    y = rng.normal(size=(30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, (16, 8)).astype(np.int32)
    lengths = rng.integers(0, 9, 16)
    valid = np.arange(8)[None, :] < lengths[:, None]
    conf = {"positive": rng.uniform(1.0, 5.0, (16, 8)), "below_one_and_negative": rng.uniform(-3.0, 3.0, (16, 8)),
            "singular": rng.uniform(0.5, 2.0, (16, 8))}[case]
    conf = np.where(valid, conf, 0.0).astype(np.float32)
    if case == "singular":
        y[:, 2] = 0.0
    return y, idx, conf, 0.0 if case == "singular" else 0.1


@pytest.mark.parametrize("case", ["positive", "below_one_and_negative", "singular"])
def test_als_solve_batch_matches_jax(case: str) -> None:
    import jax.numpy as jnp

    from rectools_tpu.ops import als as jax_als

    y, idx, conf, reg = _als_case(case)
    yty = np.array(jax_als._yty_reg(jnp.asarray(y), jnp.float32(reg)))
    np.testing.assert_allclose(port_als_ops._yty_reg(torch.from_numpy(y), reg).numpy(), yty, rtol=1e-6, atol=1e-5)
    expected = np.asarray(jax_als._solve_batch(jnp.asarray(y), jnp.asarray(yty), jnp.asarray(idx), jnp.asarray(conf)))
    got = port_als_ops._solve_batch(torch.from_numpy(y), torch.from_numpy(yty), torch.from_numpy(idx).long(),
                                    torch.from_numpy(conf)).numpy()
    if case == "singular":  # the Gram misses a direction: JAX's Cholesky gives NaN, the port a NaN row
        assert np.isnan(expected).all() and np.isnan(got).all()
    else:
        assert np.isfinite(got).all()
        _close(got, expected, 1e-5)


def test_als_bucket_packing_matches_jax() -> None:
    """Skewed degrees under a small area budget: the same spans and the same
    padded (rows, idx, conf) arrays."""
    from rectools_tpu.ops import als as jax_als

    rng = np.random.default_rng(6)
    lengths = np.minimum(rng.zipf(1.5, 400), 300)
    lengths[::7] = 0
    rows = np.repeat(np.arange(400), lengths)
    cols = np.concatenate([rng.choice(500, n, replace=False) for n in lengths])
    csr = sparse.csr_matrix((rng.uniform(0.5, 3.0, len(rows)).astype(np.float32), (rows, cols)), shape=(400, 500))
    for batch_size, budget in ((64, 1 << 10), (2048, 1 << 22)):
        sorted_lengths = np.sort(np.diff(csr.indptr))
        assert port_als_ops._bucket_spans(sorted_lengths, batch_size, budget) == jax_als._bucket_spans(
            sorted_lengths, batch_size, budget)
        got = port_als_ops._pack_degree_buckets(csr, batch_size, 400, budget)
        expected = jax_als._pack_degree_buckets(csr, batch_size, 400, budget)
        assert len(got) == len(expected) > (1 if budget < 1 << 22 else 0)
        for a, b in zip(got, expected):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def _confidences(seed: int, negative: bool) -> sparse.csr_matrix:
    rng = np.random.default_rng(seed)
    dense = (rng.random((60, 40)) < 0.15) * rng.uniform(-2.0 if negative else 0.2, 4.0, (60, 40))
    dense[3] = 0.0  # a subject with no interactions
    return sparse.csr_matrix(dense.astype(np.float32))


@pytest.mark.parametrize("negative", [False, True], ids=["below_one", "negative"])
def test_als_half_step_matches_jax(negative: bool) -> None:
    from rectools_tpu.ops import als as jax_als

    csr = _confidences(7, negative)
    y = np.random.default_rng(8).normal(size=(40, 5)).astype(np.float32)
    expected = jax_als.als_half_step(csr, y, 0.3)
    got = port_als_ops.als_half_step(csr, y, 0.3, device="cpu")
    assert got.dtype == np.float32 and not got[3].any()
    _close(got, expected, 1e-5)


@pytest.mark.parametrize("resets", [False, True])
@pytest.mark.parametrize("negative", [False, True], ids=["below_one", "negative"])
def test_als_fit_matches_jax(negative: bool, resets: bool) -> None:
    from rectools_tpu.ops import als as jax_als

    csr = _confidences(9, negative)
    rng = np.random.default_rng(10)
    u0, i0 = (rng.random((60, 6)) * 0.01).astype(np.float32), (rng.random((40, 6)) * 0.01).astype(np.float32)
    kwargs = {}
    if resets:
        kwargs = dict(user_reset_cols=(0, 2), user_reset_values=rng.random((60, 2)).astype(np.float32),
                      item_reset_cols=(5, 6), item_reset_values=rng.random((40, 1)).astype(np.float32))
    expected = jax_als.als_fit(csr, u0.copy(), i0.copy(), 0.5, 3, **kwargs)
    got = port_als_ops.als_fit(csr, u0.copy(), i0.copy(), 0.5, 3, device="cpu", **kwargs)
    for a, b in zip(got, expected):
        _close(a, b, 1e-4)
    if resets:
        np.testing.assert_array_equal(got[0][:, :2], kwargs["user_reset_values"])
        np.testing.assert_array_equal(got[1][:, 5:], kwargs["item_reset_values"])


# ------------------------------------------------------------------ BPR ops


def test_bpr_csr_contains_matches_jax() -> None:
    import jax.numpy as jnp

    from rectools_tpu.ops.bpr import _csr_contains as jax_contains

    rng = np.random.default_rng(11)
    dense = (rng.random((50, 70)) < 0.2).astype(np.float32)
    dense[7] = 0.0  # an empty row
    csr = sparse.csr_matrix(dense)
    coo = csr.tocoo()
    u, j = rng.integers(0, 50, 2000), rng.integers(0, 70, 2000)
    expected = np.asarray(jax_contains(jnp.asarray(csr.indices), jnp.asarray(csr.indptr), jnp.asarray(u),
                                       jnp.asarray(j)))
    keys = torch.from_numpy(coo.row.astype(np.int64) * 70 + coo.col)
    got = port_bpr_ops._csr_contains(keys, 70, torch.from_numpy(u), torch.from_numpy(j)).numpy()
    np.testing.assert_array_equal(got, expected)
    assert got.any() and not got.all()


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("batch_size", [64, 10**6], ids=["batches", "clamped"])
def test_bpr_epochs_on_jax_draws_match_jax(verify: bool, batch_size: int) -> None:
    """Five epochs on JAX's own permutations and negatives; 531 interactions
    leave a wrap-around tail at batch 64, and the batch is clamped to them
    at 10**6."""
    from rectools_tpu.ops.bpr import bpr_fit as jax_bpr_fit

    rng = np.random.default_rng(12)
    csr = sparse.csr_matrix((rng.random((60, 45)) < 0.2).astype(np.float32))
    assert csr.nnz % 64
    expected = jax_bpr_fit(csr, 8, 0.05, 0.01, 5, 3, verify, batch_size)
    got = port_bpr_ops.bpr_fit(csr, 8, 0.05, 0.01, 5, 3, verify, batch_size, device="cpu",
                               draw=_jax_bpr_draws(3, 45))
    for a, b in zip(got, expected):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_bpr_verified_negatives_skip_seen_items() -> None:
    """Every draw hits a seen item (a user who saw the whole catalog): with
    verification nothing moves but the positives' rows, without it the
    negatives' rows move too."""
    csr = sparse.csr_matrix(np.ones((3, 4), np.float32))
    initial = (np.full((3, 2), 0.5, np.float32), np.full((4, 2), 0.25, np.float32), np.zeros(4, np.float32))
    verified = port_bpr_ops.bpr_fit(csr, 2, 0.1, 0.0, 1, 0, True, 4, initial=initial, device="cpu")
    for got, start in zip(verified, initial):
        np.testing.assert_array_equal(got, start)
    plain = port_bpr_ops.bpr_fit(csr, 2, 0.1, 0.0, 1, 0, False, 4, initial=initial, device="cpu")
    assert not np.array_equal(plain[0], initial[0])


# ------------------------------------------------------------------ HybridMF ops


@pytest.mark.parametrize("schedule", ["adagrad", "adadelta"])
@pytest.mark.parametrize("loss", ["logistic", "bpr", "warp", "warp-kos"])
def test_hybrid_mf_train_step_matches_jax(loss: str, schedule: str) -> None:
    """Three steps from JAX's initial tables on JAX's negatives: losses and
    every table (dense gradients, the optimizers by hand) as JAX's."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.ops import hybrid_mf as jax_hmf

    rng = np.random.default_rng(13)
    n_users, n_items, b, m, d = 20, 15, 16, 4, 6
    user_design = sparse.hstack([sparse.identity(n_users, format="csr"),
                                 sparse.csr_matrix((rng.random((n_users, 3)) < 0.5).astype(np.float32))]).tocsr()
    item_design = sparse.hstack([sparse.identity(n_items, format="csr"),
                                 sparse.csr_matrix((rng.random((n_items, 4)) < 0.5).astype(np.float32))]).tocsr()
    u_idx, u_val = jax_hmf.pad_feature_table(user_design)
    i_idx, i_val = port_hmf_ops.pad_feature_table(item_design)
    for a, c in zip((u_idx, u_val), port_hmf_ops.pad_feature_table(user_design)):
        np.testing.assert_array_equal(a, c)
    params = jax_hmf.init_params(user_design.shape[1], item_design.shape[1], d, 0)
    tx = jax_hmf.make_optimizer(schedule, 0.05, 0.95, 1e-6)
    state = tx.init(params)
    port_params = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    optimizer = port_hmf_ops.make_optimizer(schedule, 0.05, 0.95, 1e-6)
    port_state = optimizer.init(port_params)
    key = jax.random.PRNGKey(17)
    for step in range(3):
        users = rng.integers(0, n_users, b)
        pos = rng.integers(0, n_items, (b, 5) if loss == "warp-kos" else b)
        if loss == "logistic":
            weights = rng.choice([-1.0, 1.0, 2.0, 0.0], b).astype(np.float32)
        else:
            weights = np.r_[np.ones(b - 2), 0.0, 0.0].astype(np.float32)
        step_key = jax.random.fold_in(key, step)
        params, state, loss_jax = jax_hmf.train_step(
            params, state, jnp.asarray(u_idx[users]), jnp.asarray(u_val[users]), jnp.asarray(i_idx),
            jnp.asarray(i_val), jnp.asarray(pos), jnp.asarray(weights), step_key, loss=loss, max_sampled=m,
            n_items=n_items, tx=tx, user_alpha=0.01, item_alpha=0.02, kos_k=2)
        negatives = torch.from_numpy(np.array(jax.random.randint(step_key, (b, m), 0, n_items))).long()
        port_params, port_state, loss_port = port_hmf_ops.train_step(
            port_params, port_state, torch.from_numpy(u_idx[users]).long(), torch.from_numpy(u_val[users]),
            torch.from_numpy(i_idx).long(), torch.from_numpy(i_val), torch.from_numpy(pos).long(),
            torch.from_numpy(weights), None if loss == "logistic" else negatives, loss=loss, n_items=n_items,
            optimizer=optimizer, user_alpha=0.01, item_alpha=0.02, kos_k=2)
        np.testing.assert_allclose(float(loss_port), float(loss_jax), rtol=1e-6)
        for name, table in params.items():
            np.testing.assert_allclose(port_params[name].numpy(), np.asarray(table), rtol=0, atol=1e-6, err_msg=name)


def test_hybrid_mf_unknown_schedule_is_refused() -> None:
    with pytest.raises(ValueError, match="learning_schedule"):
        port_hmf_ops.make_optimizer("sgd", 0.1, 0.9, 1e-6)


# ------------------------------------------------------------------ models: fit, fit_partial, serving


def _fitted_close(name: str, got: tp.Any, expected: tp.Any) -> None:
    scale = {"als": 1e-4, "bpr": 1e-6, "hybrid": 1e-5}[name.split("_")[0]]
    got_arrays, expected_arrays = fitted_arrays(got), fitted_arrays(expected)
    if name.startswith("hybrid"):
        got_arrays, expected_arrays = got_arrays["params"], expected_arrays["params"]
    for key, value in expected_arrays.items():
        _close(got_arrays[key], np.asarray(value), scale)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_and_fit_partial_match_jax(name: str, frame: str, monkeypatch: pytest.MonkeyPatch) -> None:
    """fit, then fit_partial for one more epoch, on JAX's draws (BPR's
    permutations and negatives, HybridMF's initial tables and negatives)."""
    _inject_jax_draws(name, monkeypatch)
    dataset, jax_dataset = _datasets(frame)
    port, jax_model = _models(name)
    port.fit(dataset)
    jax_model.fit(jax_dataset)
    _fitted_close(name, port, jax_model)
    port.fit_partial(dataset, 1)
    jax_model.fit_partial(jax_dataset, 1)
    _fitted_close(name, port, jax_model)
    if name.startswith("hybrid"):
        assert port._epochs_trained == jax_model._epochs_trained == MODELS[name][1]["epochs"] + 1
        assert len(port.train_loss_history) == port._epochs_trained


def test_als_separate_features_and_fresh_fit_partial_match_jax() -> None:
    """Features fitted separately (one paired half-step per feature block),
    and fit_partial on an unfitted model (a fresh start)."""
    dataset, jax_dataset = _datasets("seeded")
    port, jax_model = _models("als")
    port.fit_partial(dataset, 2)
    jax_model.fit_partial(jax_dataset, 2)
    assert port.user_factors.shape[1] == port.item_factors.shape[1] == 4 + 8 + 5  # latent, user, item blocks
    _fitted_close("als", port, jax_model)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", ["als", "bpr", "hybrid_warp"])
def test_serving_from_jax_fitted_arrays_matches_jax(name: str, frame: str) -> None:
    dataset, jax_dataset = _datasets(frame)
    port, jax_model = _models(name)
    jax_model.fit(jax_dataset)
    load_fitted_arrays(port, fitted_arrays(jax_model))
    users = np.unique(_interactions(frame)[Columns.User])
    items = np.unique(_interactions(frame)[Columns.Item])
    whitelist = items[::2]
    hot_warm_cold = np.append(users[:5], [WARM_USER, COLD_USER])
    calls = [
        ("recommend", dict(users=users, k=3, filter_viewed=True)),
        ("recommend", dict(users=users, k=3, filter_viewed=False)),
        ("recommend", dict(users=users, k=3, filter_viewed=True, items_to_recommend=whitelist)),
        ("recommend", dict(users=hot_warm_cold, k=3, filter_viewed=True, on_unsupported_targets="ignore")),
        ("recommend_to_items", dict(target_items=items, k=3)),
        ("recommend_to_items", dict(target_items=np.append(items[:4], 10**6), k=2, items_to_recommend=whitelist,
                                    filter_itself=False, on_unsupported_targets="ignore")),
    ]
    for method, kwargs in calls:
        got = getattr(port, method)(dataset=dataset, **kwargs)
        expected = getattr(jax_model, method)(dataset=jax_dataset, **kwargs)
        assert len(got) > 0, (method, kwargs)
        _assert_reco_equal(got, expected)
    if port.recommends_for_cold:  # HybridMF serves warm users by features and cold ones by item biases
        served = set(port.recommend(hot_warm_cold, dataset, 3, True, on_unsupported_targets="ignore")[Columns.User])
        assert {WARM_USER, COLD_USER} <= served


@pytest.mark.parametrize("name", ["als", "bpr", "hybrid_warp"])
def test_get_vectors_match_jax(name: str) -> None:
    dataset, jax_dataset = _datasets("seeded")
    port, jax_model = _models(name)
    jax_model.fit(jax_dataset)
    load_fitted_arrays(port, fitted_arrays(jax_model))
    args = (dataset,) if name.startswith("hybrid") else ()
    jax_args = (jax_dataset,) if name.startswith("hybrid") else ()
    for got, expected in zip(port.get_vectors(*args), jax_model.get_vectors(*jax_args)):
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("name", ["als", "bpr", "hybrid_warp"])
def test_load_fitted_arrays_checks_names_shapes_and_dtypes(name: str) -> None:
    port, _ = _models(name)
    f32 = np.float32
    bad = {
        "als": [{"user_factors": np.zeros((3, 4), f32), "item_factors": np.zeros((5, 3), f32)},
                {"user_factors": np.zeros((3, 2), f32), "item_factors": np.zeros((5, 2), f32)},
                {"user_factors": np.zeros((3, 4), np.float64), "item_factors": np.zeros((5, 4), f32)}],
        "bpr": [{"user_embeddings": np.zeros((3, 8), f32), "item_embeddings": np.zeros((5, 8), f32),
                 "item_biases": np.zeros(4, f32)},
                {"user_embeddings": np.zeros((3, 8), f32), "item_embeddings": np.zeros((5, 8), f32)}],
        "hybrid_warp": [{"params": {"user_emb": np.zeros((3, 8), f32), "user_bias": np.zeros(3, f32),
                                    "item_emb": np.zeros((5, 8), f32)}},
                        {"params": {"user_emb": np.zeros((3, 7), f32), "user_bias": np.zeros(3, f32),
                                    "item_emb": np.zeros((5, 8), f32), "item_bias": np.zeros(5, f32)}}],
    }[name]
    for arrays in bad:
        with pytest.raises(ValueError, match="load_fitted_arrays"):
            load_fitted_arrays(port, arrays)
    assert not port.is_fitted


# ------------------------------------------------------------------ configs, pickles, aliases, devices


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_round_trip_and_jax_config(name: str) -> None:
    port, jax_model = _models(name)
    config = port.get_config()
    assert config["device"] == "cpu" and config["cls"] is type(port)
    assert type(port).from_config(config).get_config() == config
    assert model_from_config(port.get_config(simple_types=True)).get_config() == config
    # a JAX config (class by its short name, no device) loads into the port class
    jax_config = jax_model.get_config(simple_types=True)
    loaded = model_from_config({**jax_config, "device": "cpu"})
    assert type(loaded) is type(port)
    assert {k: v for k, v in loaded.get_config(simple_types=True).items() if k != "device"} == jax_config


@pytest.mark.parametrize("name", ["als_together", "bpr", "hybrid_kos"])
def test_dumps_loads_keep_the_fitted_model(name: str) -> None:
    dataset, _ = _datasets("seeded")
    port, _ = _models(name)
    port.fit(dataset)
    users = np.unique(_interactions("seeded")[Columns.User])
    restored = pickle.loads(pickle.dumps(port))
    _assert_reco_equal(restored.recommend(users, dataset, 3, True), port.recommend(users, dataset, 3, True))
    if name.startswith("hybrid"):  # fit_partial after a reload continues from the pickled tables and state
        port.fit_partial(dataset, 1)
        restored.fit_partial(dataset, 1)
        for key, value in port.params.items():
            np.testing.assert_array_equal(restored.params[key], value)


def test_reference_aliases_and_exports() -> None:
    import rectools_tpu.models as jax_models
    import rectools_tpu_torch.models as port_models

    assert ImplicitALSWrapperModel is ALSModel and ImplicitBPRWrapperModel is BPRModel
    assert LightFMWrapperModel is HybridMFModel
    for alias, cls in (("ImplicitALSWrapperModel", ALSModel), ("ImplicitBPRWrapperModel", BPRModel),
                       ("LightFMWrapperModel", HybridMFModel)):
        assert type(model_from_config({"cls": alias, "device": "cpu"})) is cls
    expected = (set(jax_models.__all__) - {"TPURanker"}) | {"TorchRanker"}
    assert set(port_models.__all__) == expected
    assert all(hasattr(port_models, name) for name in expected)


def test_als_mesh_shape_stays_in_the_config_and_fit_refuses_it() -> None:
    model = ALSModel(factors=4, iterations=1, mesh_shape=(2, 2), device="cpu")
    assert ALSModel.from_config(model.get_config()).mesh_shape == (2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 6"):
        model.fit(_datasets("tiny", features=False)[0])


@pytest.mark.parametrize("cls", [ALSModel, BPRModel, HybridMFModel])
def test_default_device_is_the_card(cls: tp.Any) -> None:
    if torch.cuda.is_available():
        assert cls().get_config()["device"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cls()


# ------------------------------------------------------------------ the port's own draws


def test_bpr_generator_draws_are_permutations_and_uniform() -> None:
    draw = port_bpr_ops.generator_draws(torch.Generator().manual_seed(0), 20)
    perm, negs = draw(0, 1000, 50, 40)
    assert sorted(perm.tolist()) == list(range(1000))
    counts = np.bincount(negs.flatten().numpy(), minlength=20)
    assert counts.sum() == 2000 and len(counts) == 20
    assert stats.chisquare(counts).statistic < stats.chi2.ppf(0.999, 19)
    perm2, negs2 = draw(1, 1000, 50, 40)
    assert not torch.equal(perm, perm2) and not torch.equal(negs, negs2)


def test_hybrid_mf_own_draws_are_uniform() -> None:
    negs = port_hmf_ops.negative_draws(torch.Generator().manual_seed(1), 30, 10)(0, 300).flatten().numpy()
    counts = np.bincount(negs, minlength=30)
    assert len(counts) == 30 and stats.chisquare(counts).statistic < stats.chi2.ppf(0.999, 29)
    params = port_hmf_ops.init_params(400, 300, 10, torch.Generator().manual_seed(2))
    for side in ("user", "item"):
        emb = params[f"{side}_emb"].numpy()
        assert emb.min() >= -0.1 and emb.max() <= 0.1 and not params[f"{side}_bias"].any()
        assert abs(emb.mean()) < 3e-3 and abs(emb.std() - 0.1 / np.sqrt(3)) < 2e-3  # U(-0.1, 0.1)


@pytest.mark.parametrize("name", ["bpr", "hybrid_warp", "hybrid_kos"])
def test_refit_from_the_seed_repeats_bit_for_bit(name: str) -> None:
    dataset, _ = _datasets("seeded")
    first, _ = _models(name)
    second, _ = _models(name)
    first.fit(dataset)
    second.fit(dataset)
    for key, value in fitted_arrays(first).items():
        value = value if isinstance(value, dict) else {key: value}
        other = fitted_arrays(second)[key]
        other = other if isinstance(other, dict) else {key: other}
        for k, v in value.items():
            np.testing.assert_array_equal(other[k], v)
    other_seed, _ = _models(name, random_state=99)
    other_seed.fit(dataset)
    assert not np.array_equal(fitted_arrays(other_seed).get("user_embeddings", 0.0),
                              fitted_arrays(first).get("user_embeddings", 1.0))
    if name.startswith("hybrid"):
        assert first.train_loss_history == second.train_loss_history
        assert not np.array_equal(other_seed.params["user_emb"], first.params["user_emb"])
