"""The port's mesh (data x model) training on ``torch.distributed``, held
against the JAX package's mesh training and against the port's own
single-process training, on the CPU.

The port's ranks are real processes: ``parallel.launch.run_ranks`` spawns
them, they join a gloo world through a ``file://`` store and run the worker
functions of this module on CPU tensors (every kernel through its plain
twin). Two worlds are started per test session, one of four ranks and one of
two, and each does many checks, because a spawn costs seconds. The workers
get numpy inputs and return numpy results; the JAX references are computed in
the pytest process on the 8-device CPU mesh (at (2, 4) or (4, 2): the results
do not depend on the mesh beyond summation order). JAX is imported inside the
test functions only, so the spawned ranks, which import this module, run
without it.

The four-rank world also writes a (2, 2) fit's checkpoint, which must hold
whole-table Adam moments and resume, at (2, 2) and in one process, as the
fit itself goes on.

Tolerances: lse 1e-5 relative, gradients 1e-5 of each output's largest
entry, losses against JAX 1e-4 relative and parameters 1e-4 (the attention
key-projection biases, whose gradient is rounding noise, within steps * lr),
losses of a mesh fit against the port's single-process fit 1e-5 relative.
"""

import functools
import typing as tp

import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn.transformers import flax_params_to_state_dict
from rectools_tpu_torch.models.nn.transformers.training import pad_batch
from rectools_tpu_torch.ops import softmax_lse
from rectools_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, collectives, make_mesh, pad_to_multiple
from rectools_tpu_torch.parallel import distributed as port_dist
from rectools_tpu_torch.parallel.launch import run_ranks

CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5)
TRAINING_KWARGS = {"fused_softmax_chunk": 64, "val_recall_k": 5}
LR = 1e-3
LSE_CASES = {"ragged": (96, 301, 32), "empty_shard": (32, 3, 16)}  # name: (M, N, D)
MESHES = ((2, 2), (1, 4), (4, 1))
SPAWN_TIMEOUT_S = 420.0

# shared negatives with remat: the training options of the sampled softmax
SHARED_REMAT = {"loss": "sampled_softmax", "negatives_sharing": "batch", "remat": True}


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
    ).astype({Columns.Datetime: "datetime64[ns]"})


def leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


def is_key_projection_bias(name: str) -> bool:
    """Zero gradient in exact arithmetic (see tests/test_torch_training.py)."""
    return name.endswith("multi_head_attn.k_proj.bias")


def _lse_inputs(case: str) -> tp.Dict[str, np.ndarray]:
    m, n, d = LSE_CASES[case]
    rng = np.random.default_rng(m + n)
    return {
        "s": rng.normal(0, 0.5, (m, d)).astype(np.float32),
        "items": rng.normal(0, 0.5, (n, d)).astype(np.float32),
        "g": rng.normal(0, 1.0, (m,)).astype(np.float32),  # mixed-sign lse cotangent
    }


# ------------------------------------------------------------------ what a rank runs


def _model(
    df: pd.DataFrame,
    mesh_shape: tp.Optional[tp.Tuple[int, int]],
    dropout: float,
    start: tp.Optional[tp.Dict[str, np.ndarray]] = None,
    loss: str = "softmax",
    model_cls: tp.Any = SASRecModel,
    **training_kwargs: tp.Any,
) -> tp.Any:
    kwargs = dict(TRAINING_KWARGS, **training_kwargs)
    if mesh_shape is not None:
        kwargs["mesh_shape"] = mesh_shape
    extra = {"get_val_mask_func": leave_last_out} if model_cls is SASRecModel else {"relative_time_attention": False}
    model = model_cls(**CONFIG, dropout_rate=dropout, loss=loss, n_negatives=3, training_module_kwargs=kwargs,
                      device="cpu", **extra)
    model._build_model_from_dataset(Dataset.construct(df))
    if start is not None:
        model.training_module.load_params({k: torch.tensor(v) for k, v in start.items()})
    return model


def _first_batch(model: tp.Any) -> tp.Dict[str, np.ndarray]:
    loader = model.data_preparator.get_dataloader_train(np.random.default_rng(0))
    return pad_batch(next(iter(loader)), loader.batch_size)


def _fit_summary(model: tp.Any) -> tp.Dict[str, tp.Any]:
    tm = model.training_module
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    return {
        "train": list(tm.train_loss_history),
        "val": list(tm.val_loss_history),
        "recall": {k: list(v) for k, v in tm.val_metric_history.items()},
        "steps": tm.global_step,
        "params": {k: v.numpy() for k, v in tm.get_state()["params"].items()},
        "ids_emb_shape": tuple(model.backbone.item_model.item_net_blocks[0].ids_emb.weight.shape),
    }


def _step_gradients(model: tp.Any, batch: tp.Dict[str, np.ndarray]) -> tp.Dict[str, tp.Any]:
    """The loss and whole per-parameter gradients of one train step, as the
    step has them just before Adam."""
    tm = model.training_module
    if tm.optimizer is None:
        tm.init_params()
    tm.backbone.train()
    loss = tm._fused_softmax_loss_value(tm._device_batch(tm._local_batch(batch)))
    tm.backbone.zero_grad(set_to_none=True)
    loss.backward()
    loss = tm._sum_over_data_group(loss)
    grads = {name: p.grad for name, p in tm.backbone.named_parameters()}
    for key, block in tm._sharded_tables():
        grads[key] = torch.cat(collectives.all_gather(grads[key], block.column_mesh.group(MODEL_AXIS)), dim=1)
    return {"loss": float(loss), "grads": {k: v.numpy() for k, v in grads.items()}}


def _sharded_lse(mesh: tp.Any, inputs: tp.Dict[str, np.ndarray]) -> tp.Dict[str, np.ndarray]:
    start, stop = port_dist.data_parallel_row_range(inputs["s"].shape[0], mesh)
    s = torch.tensor(inputs["s"][start:stop], requires_grad=True)
    items = torch.tensor(inputs["items"], requires_grad=True)
    lse = softmax_lse.sharded_streaming_lse(s, items, mesh, MODEL_AXIS, data_axis=DATA_AXIS)
    (lse * torch.tensor(inputs["g"][start:stop])).sum().backward()
    return {"lse": lse.detach().numpy(), "ds": s.grad.numpy(), "di": items.grad.numpy()}


def four_rank_worker(rank: int, payload: tp.Dict[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    out: tp.Dict[str, tp.Any] = {"rank": rank}
    meshes = {shape: make_mesh(*shape) for shape in MESHES}
    out["coords"] = {shape: dict(mesh.coords) for shape, mesh in meshes.items()}
    for case, inputs in payload["lse"].items():
        for shape in ((1, 4), (2, 2)):
            out[f"lse_{case}_{shape}"] = _sharded_lse(meshes[shape], inputs)
    df, start = payload["df"], payload["start"]
    # (c) from converted JAX parameters, dropout 0: gradients of one step, one step, one epoch
    out["grads_2x2"] = _step_gradients(_model(df, (2, 2), 0.0, start), payload["first"])
    stepped = _model(df, (2, 2), 0.0, start)
    tm = stepped.training_module
    out["step_loss"] = float(tm._train_step(tm._device_batch(tm._local_batch(payload["first"]))))
    out["step_params"] = {k: v.numpy() for k, v in tm.get_state()["params"].items()}
    out["fit_from_jax"] = _fit_summary(_model(df, (2, 2), 0.0, start))
    # (d) the port's own init, dropout on
    for shape in MESHES:
        model = _model(df, shape, 0.2)
        out[f"fit_dropout_{shape}"] = _fit_summary(model)
        if shape == (2, 2):
            fitted = model
    # (g) the (2, 2) fit's checkpoint, one file written by rank 0, reloaded at (2, 2): one more epoch from it
    # and one more epoch of the fitted model itself (the uninterrupted fit); the test loads it in one process
    state = fitted.training_module.get_state()
    if rank == 0:
        torch.save(state, payload["checkpoint"])
    torch.distributed.barrier()
    resumed = _model(df, (2, 2), 0.2)
    resumed.training_module.set_state(torch.load(payload["checkpoint"]))
    out["resumed_2x2"] = _fit_summary(resumed)
    out["continued_2x2"] = _fit_summary(fitted)
    out["fit_sampled_softmax"] = _fit_summary(_model(df, (2, 2), 0.2, loss="sampled_softmax"))
    out["fit_plain_softmax"] = _fit_summary(_model(df, (2, 2), 0.2, fused_softmax_chunk=None))
    out["fit_shared_remat"] = _fit_summary(_model(df, (2, 2), 0.2, **SHARED_REMAT))
    out["fit_fused_remat"] = _fit_summary(_model(df, (2, 2), 0.2, remat=True))
    return out


def two_rank_worker(rank: int, payload: tp.Dict[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    out: tp.Dict[str, tp.Any] = {"rank": rank, "errors": {}}
    try:
        make_mesh(3, 1)
    except ValueError as error:
        out["errors"]["world"] = str(error)
    model = _model(payload["df"], (2, 1), 0.0)
    odd = {k: v[:31] for k, v in payload["first"].items()}
    try:
        model.training_module._local_batch(odd)
    except ValueError as error:
        out["errors"]["divisible"] = str(error)
    mesh = port_dist.make_multihost_mesh(n_model=2)
    out["multihost"] = (mesh.shape, mesh.ranks.tolist(), port_dist.process_count(), port_dist.process_index())
    try:
        port_dist.make_multihost_mesh(n_model=3)
    except ValueError as error:
        out["errors"]["node"] = str(error)
    # (e) one HSTU step at (2, 1), dropout on
    hstu = _model(payload["df"], (2, 1), 0.2, model_cls=HSTUModel)
    tm = hstu.training_module
    tm.init_params()
    out["hstu_loss"] = float(tm._train_step(tm._device_batch(tm._local_batch(payload["hstu_first"]))))
    out["hstu_params"] = {k: v.numpy() for k, v in tm.get_state()["params"].items()}
    return out


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def jax_mesh_run():
    """The JAX package at mesh (4, 2), dropout 0: start parameters, one train
    step on the first batch, and a one-epoch fit."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.dataset import Dataset as JaxDataset
    from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
    from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch

    df = _frame()
    model = JaxSASRecModel(
        **CONFIG, dropout_rate=0.0, get_val_mask_func=leave_last_out,
        training_module_kwargs=dict(TRAINING_KWARGS, mesh_shape=(4, 2)),
    )
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)

    def fresh():
        params = tm._shard_params(jax.tree.map(jnp.array, start))
        return params, tm._make_optimizer().init(params)

    params, opt_state = fresh()
    stepped, _, step_loss = tm._train_step(params, opt_state, tm._device_batch(first), jax.random.PRNGKey(0))
    one_step = (float(step_loss), flax_params_to_state_dict(jax.tree.map(np.array, stepped)))
    tm.params, tm.opt_state = fresh()
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    return {
        "df": df, "first": first, "one_step": one_step,
        "start": {k: v.numpy() for k, v in flax_params_to_state_dict(start).items()},
        "train": list(tm.train_loss_history), "val": list(tm.val_loss_history),
        "recall": dict(tm.val_metric_history), "steps": tm.global_step,
        "final": flax_params_to_state_dict(jax.tree.map(np.array, tm.params)),
    }


@pytest.fixture(scope="module")
def checkpoint_path(tmp_path_factory):
    """Where rank 0 of the four-rank world writes the (2, 2) fit's training state."""
    return str(tmp_path_factory.mktemp("mesh_checkpoint") / "state.pt")


@pytest.fixture(scope="module")
def four_ranks(jax_mesh_run, checkpoint_path):
    payload = {
        "df": jax_mesh_run["df"], "start": jax_mesh_run["start"], "first": jax_mesh_run["first"],
        "lse": {case: _lse_inputs(case) for case in LSE_CASES}, "checkpoint": checkpoint_path,
    }
    return run_ranks(four_rank_worker, 4, (payload,), timeout_s=SPAWN_TIMEOUT_S, backend="gloo")


@pytest.fixture(scope="module")
def two_ranks():
    df = _frame()
    payload = {
        "df": df,
        "first": _first_batch(_model(df, None, 0.0)),
        "hstu_first": _first_batch(_model(df, None, 0.2, model_cls=HSTUModel)),
    }
    return payload, run_ranks(two_rank_worker, 2, (payload,), timeout_s=SPAWN_TIMEOUT_S, backend="gloo")


@pytest.fixture(scope="module")
def single_process():
    """The port's single-process fits the mesh fits are held against."""
    df = _frame()
    return {
        "dropout": _fit_summary(_model(df, None, 0.2)),
        "sampled_softmax": _fit_summary(_model(df, None, 0.2, loss="sampled_softmax")),
        "plain_softmax": _fit_summary(_model(df, None, 0.2, fused_softmax_chunk=None)),
        "shared_remat": _fit_summary(_model(df, None, 0.2, **SHARED_REMAT)),
        "fused_remat": _fit_summary(_model(df, None, 0.2, remat=True)),
    }


def _by_coords(results: tp.Sequence[tp.Dict[str, tp.Any]], shape: tp.Tuple[int, int]) -> tp.Dict[tp.Any, int]:
    return {(r["coords"][shape][DATA_AXIS], r["coords"][shape][MODEL_AXIS]): r["rank"] for r in results}


# ------------------------------------------------------------------ (b) sharded_streaming_lse


@functools.lru_cache(maxsize=None)
def _jax_sharded_lse(case: str) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lse, ds, di) of the JAX ``sharded_streaming_lse`` on the (2, 4) CPU mesh."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.ops import softmax_lse as jax_softmax_lse
    from rectools_tpu.parallel.mesh import make_mesh as jax_make_mesh

    inputs = _lse_inputs(case)
    mesh = jax_make_mesh(n_data=2, n_model=4)

    def value(s, items):
        return jax_softmax_lse.sharded_streaming_lse(
            s, items, mesh, "model", data_axis="data", block_m=16, chunk_n=32, interpret=True
        )

    expected = np.asarray(value(jnp.asarray(inputs["s"]), jnp.asarray(inputs["items"])))
    eds, edi = jax.grad(lambda s, i: jnp.sum(value(s, i) * inputs["g"]), argnums=(0, 1))(
        jnp.asarray(inputs["s"]), jnp.asarray(inputs["items"])
    )
    return expected, np.asarray(eds), np.asarray(edi)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_sharded_streaming_lse_matches_jax(four_ranks, case: str, shape: tp.Tuple[int, int]) -> None:
    inputs = _lse_inputs(case)
    expected, eds, edi = _jax_sharded_lse(case)
    where = _by_coords(four_ranks, shape)
    key = f"lse_{case}_{shape}"
    n_data, n_model = shape
    # the ranks of a model group hold the same rows and agree exactly
    for d in range(n_data):
        for m in range(1, n_model):
            for name in ("lse", "ds", "di"):
                peer, first = four_ranks[where[(d, m)]][key], four_ranks[where[(d, 0)]][key]
                np.testing.assert_array_equal(peer[name], first[name])
    rows = [four_ranks[where[(d, 0)]][key] for d in range(n_data)]
    lse = np.concatenate([r["lse"] for r in rows])
    ds = np.concatenate([r["ds"] for r in rows])
    di = sum(r["di"] for r in rows)  # the data group's sum, as the train step takes it
    assert np.isfinite(lse).all()
    np.testing.assert_allclose(lse, expected, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ds, eds, atol=1e-5 * np.abs(eds).max())
    np.testing.assert_allclose(di, edi, atol=1e-5 * np.abs(edi).max())
    assert di.shape == inputs["items"].shape


# ------------------------------------------------------------------ (c) against the JAX mesh fit


def _assert_params_close(got: tp.Dict[str, np.ndarray], expected: tp.Dict[str, torch.Tensor], atol: float, steps: int):
    assert set(got) == set(expected)
    for name, value in got.items():
        tol = steps * LR if is_key_projection_bias(name) else atol
        err = np.abs(value - expected[name].numpy()).max()
        assert err <= tol, (name, err)


def test_mesh_train_step_matches_jax_mesh(jax_mesh_run, four_ranks) -> None:
    expected_loss, expected_params = jax_mesh_run["one_step"]
    for result in four_ranks:
        np.testing.assert_allclose(result["step_loss"], expected_loss, rtol=1e-5)
        _assert_params_close(result["step_params"], expected_params, atol=1e-5, steps=1)


def test_mesh_fit_matches_jax_mesh_fit(jax_mesh_run, four_ranks) -> None:
    for result in four_ranks:
        fit = result["fit_from_jax"]
        assert fit["steps"] == jax_mesh_run["steps"] == 7
        np.testing.assert_allclose(fit["train"], jax_mesh_run["train"], rtol=1e-4)
        np.testing.assert_allclose(fit["val"], jax_mesh_run["val"], rtol=1e-4)
        assert fit["recall"].keys() == jax_mesh_run["recall"].keys() == {"val_recall@5"}
        np.testing.assert_allclose(fit["recall"]["val_recall@5"], jax_mesh_run["recall"]["val_recall@5"])
        _assert_params_close(fit["params"], jax_mesh_run["final"], atol=1e-4, steps=fit["steps"])


def test_mesh_step_gradients_match_single_process(jax_mesh_run, four_ranks) -> None:
    """Every parameter's gradient at (2, 2) is the single-process gradient of
    the same global batch: it fails if the session gradient is not summed over
    the model group, the tower gradient not gathered over it, or the
    parameter gradients not summed over the data group."""
    single = _step_gradients(_model(jax_mesh_run["df"], None, 0.0, jax_mesh_run["start"]), jax_mesh_run["first"])
    largest = max(np.abs(g).max() for g in single["grads"].values())
    for result in four_ranks:
        np.testing.assert_allclose(result["grads_2x2"]["loss"], single["loss"], rtol=1e-6)
        assert result["grads_2x2"]["grads"].keys() == single["grads"].keys()
        for name, grad in single["grads"].items():
            got = result["grads_2x2"]["grads"][name]
            assert got.shape == grad.shape, name
            tol = 1e-5 * max(np.abs(grad).max(), 1e-3 * largest)
            assert np.abs(got - grad).max() <= tol, (name, np.abs(got - grad).max(), tol)


# ------------------------------------------------------------------ (d) against the port's single-process fit


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_fit_with_dropout_matches_single_process(four_ranks, single_process, shape) -> None:
    expected = single_process["dropout"]
    for result in four_ranks:
        fit = result[f"fit_dropout_{shape}"]
        assert fit["steps"] == expected["steps"]
        np.testing.assert_allclose(fit["train"], expected["train"], rtol=1e-5)
        np.testing.assert_allclose(fit["val"], expected["val"], rtol=1e-5)
        np.testing.assert_allclose(fit["recall"]["val_recall@5"], expected["recall"]["val_recall@5"])
        for name, value in fit["params"].items():
            tol = fit["steps"] * LR if is_key_projection_bias(name) else 1e-4
            assert np.abs(value - expected["params"][name]).max() <= tol, name


def test_mesh_fused_softmax_remat_fit_matches_single_process(four_ranks, single_process) -> None:
    """The full-catalog fused softmax with remat under a (2, 2) mesh: the
    recompute runs the column-sharded catalog's collectives again inside the
    checkpoint, and the fit stays the single-process remat fit's."""
    expected = single_process["fused_remat"]
    for result in four_ranks:
        fit = result["fit_fused_remat"]
        assert fit["steps"] == expected["steps"]
        np.testing.assert_allclose(fit["train"], expected["train"], rtol=1e-5)
        np.testing.assert_allclose(fit["val"], expected["val"], rtol=1e-5)
        np.testing.assert_allclose(fit["recall"]["val_recall@5"], expected["recall"]["val_recall@5"])
        for name, value in fit["params"].items():
            tol = fit["steps"] * LR if is_key_projection_bias(name) else 1e-4
            assert np.abs(value - expected["params"][name]).max() <= tol, name


@pytest.mark.parametrize("loss", ["sampled_softmax", "plain_softmax", "shared_remat"])
def test_mesh_fit_of_unfused_losses_matches_single_process(four_ranks, single_process, loss: str) -> None:
    """Device-drawn negatives (a rank draws its rows of the global draw), the
    plain full-catalog softmax, and shared negatives (a rank draws its rows of
    the global (B, K) set) with remat (the recompute gathers the column-sharded
    table again) under a mesh."""
    for result in four_ranks:
        np.testing.assert_allclose(result[f"fit_{loss}"]["train"], single_process[loss]["train"], rtol=1e-5)
        np.testing.assert_allclose(result[f"fit_{loss}"]["val"], single_process[loss]["val"], rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_agree_and_tables_are_column_sharded(four_ranks, shape) -> None:
    key = f"fit_dropout_{shape}"
    n_items = four_ranks[0][key]["params"]["item_model.item_net_blocks.0.ids_emb.weight"].shape[0]
    for result in four_ranks:
        assert result[key]["ids_emb_shape"] == (n_items, CONFIG["n_factors"] // shape[1])
        assert result[key]["train"] == four_ranks[0][key]["train"]
        assert result[key]["val"] == four_ranks[0][key]["val"]
        for name, value in result[key]["params"].items():
            np.testing.assert_array_equal(value, four_ranks[0][key]["params"][name], err_msg=name)


# ------------------------------------------------------------------ (g) a mesh fit's checkpoint


def _assert_fits_close(got: tp.Dict[str, tp.Any], expected: tp.Dict[str, tp.Any]) -> None:
    assert got["steps"] == expected["steps"]
    np.testing.assert_allclose(got["train"], expected["train"], rtol=1e-5)
    np.testing.assert_allclose(got["val"], expected["val"], rtol=1e-5)
    for name, value in got["params"].items():
        tol = got["steps"] * LR if is_key_projection_bias(name) else 1e-4
        assert np.abs(value - expected["params"][name]).max() <= tol, name


@pytest.mark.parametrize("where", ["mesh_2x2", "one_process"])
def test_mesh_checkpoint_holds_whole_moments_and_resumes(four_ranks, checkpoint_path, where: str) -> None:
    """A (2, 2) fit's checkpoint holds whole-table Adam moments, and one more
    epoch from it, at (2, 2) or in one process, is the uninterrupted fit's
    second epoch (the mesh checks' tolerance)."""
    state = torch.load(checkpoint_path)
    single = _model(_frame(), None, 0.2)
    names = [name for name, _ in single.training_module.backbone.named_parameters()]
    moments = state["opt_state"]["state"]
    assert sorted(moments) == list(range(len(names)))
    for index, name in enumerate(names):
        for moment in ("exp_avg", "exp_avg_sq"):
            assert moments[index][moment].shape == state["params"][name].shape, (name, moment)
    assert state["params"]["item_model.item_net_blocks.0.ids_emb.weight"].shape[1] == CONFIG["n_factors"]
    if where == "one_process":
        single.training_module.set_state(state)
        resumed = [_fit_summary(single)]
    else:
        resumed = [result["resumed_2x2"] for result in four_ranks]
    for result, got in zip(four_ranks, resumed):
        assert got["steps"] == 2 * result["fit_dropout_(2, 2)"]["steps"]
        _assert_fits_close(got, result["continued_2x2"])


# ------------------------------------------------------------------ (e), (f) the two-rank world


def test_hstu_mesh_step_matches_single_process(two_ranks) -> None:
    payload, results = two_ranks
    single = _model(payload["df"], None, 0.2, model_cls=HSTUModel)
    tm = single.training_module
    tm.init_params()
    loss = float(tm._train_step(tm._device_batch(payload["hstu_first"])))
    expected = {k: v.numpy() for k, v in tm.get_state()["params"].items()}
    for result in results:
        np.testing.assert_allclose(result["hstu_loss"], loss, rtol=1e-5)
        for name, value in result["hstu_params"].items():
            assert np.abs(value - expected[name]).max() <= 1e-5, name


def test_mesh_errors_and_multihost_mesh(two_ranks) -> None:
    _, results = two_ranks
    for rank, result in enumerate(results):
        assert "must equal the world size 2" in result["errors"]["world"]
        assert "Batch size 31 must be divisible by the data-axis size 2" in result["errors"]["divisible"]
        assert "must divide the ranks of a node 2" in result["errors"]["node"]
        shape, ranks, count, index = result["multihost"]
        assert shape == {DATA_AXIS: 1, MODEL_AXIS: 2} and ranks == [[0, 1]] and (count, index) == (2, rank)


def test_single_process_runtime() -> None:
    port_dist.initialize()  # one process, no coordinator: nothing to join
    assert not port_dist.is_initialized()
    assert (port_dist.process_count(), port_dist.process_index()) == (1, 0)
    mesh = make_mesh()
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.group(DATA_AXIS) is None
    assert port_dist.data_parallel_row_range(32, mesh) == (0, 32)
    batch = {"x": np.arange(6).reshape(3, 2)}
    np.testing.assert_array_equal(port_dist.global_batch_to_local(batch, mesh)["x"], batch["x"])
    assert pad_to_multiple(15835, 4) == 15836
    with pytest.raises(ValueError, match="world size 1"):
        make_mesh(2, 2)


def test_mesh_of_one_fit_equals_plain_fit(single_process) -> None:
    """``mesh_shape=(1, 1)`` in one process: the mesh route of the loss
    (kernel 8 and 9's twins) against the single-device route (6 and 7's)."""
    fit = _fit_summary(_model(_frame(), (1, 1), 0.2))
    np.testing.assert_allclose(fit["train"], single_process["dropout"]["train"], rtol=1e-5)
    np.testing.assert_allclose(fit["val"], single_process["dropout"]["val"], rtol=1e-5)


def test_failing_rank_fails_the_launch() -> None:
    with pytest.raises(RuntimeError, match="ranks .* failed"):
        run_ranks(failing_worker, 2, timeout_s=120.0, backend="gloo")


def failing_worker(rank: int) -> int:
    if rank == 1:
        raise ValueError("rank 1 gives up")
    # rank 0 waits in a collective that rank 1 never joins: the launcher ends it
    collectives.all_reduce_sum(torch.zeros(1), make_mesh(2, 1).group(DATA_AXIS))
    return rank
