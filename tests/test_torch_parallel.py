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

The same worlds also train with bf16 compute (``compute_dtype="bfloat16"``,
the bf16 forms of kernels 8-11 through their twins): the sharded lse against
JAX's on bf16 towers, a (2, 2) step and fit against JAX's bf16 mesh fit at
(4, 2), a (2, 2) fit against the port's single-process bf16 fit, and an HSTU
step at (2, 1). Their tolerances stand beside the values measured (BF16_*
below).
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

BF16 = {"compute_dtype": "bfloat16"}
# bf16 towers have kernels at widths 32-128 only: the empty shard at D = 32
BF16_LSE_CASES = {"ragged": (96, 301, 32), "empty_shard": (32, 3, 32)}
# Measured on the CPU, and the limits of the bf16 mesh checks:
# - the sharded lse against JAX's on bf16 towers: lse 1e-6 relative (5.1e-7 measured); ds and di, each rounded
#   to bf16 on both sides and ds summed over the model group in bf16 in another order, relative to the largest
#   entry 2^-7, one bf16 step of an entry in the largest one's binade (4.8e-3 and 3.8e-3);
# - a (2, 2) step and a one-epoch (7-step) fit against JAX's bf16 mesh fit at (4, 2): losses 1e-4 relative (the
#   step 6.1e-5, the fit's train and validation losses 1.5e-5 and 3.3e-5: bf16 layers that round at other places
#   in places, as tests/test_torch_bf16.py states); parameters: Adam moves an entry whose bf16 gradient is
#   rounding noise on both sides by up to lr a step on each, so every entry within 2 x steps x lr (2.0e-3 after
#   one step, 7.6e-3 after seven), and the mean over all entries within 3e-5 a step (1.3e-5 after one, 7.6e-5
#   after seven);
# - the (2, 2) bf16 fit with dropout against the single-process bf16 fit: losses 1e-4 relative (3.7e-5), the
#   parameters as above (mean 4.2e-5, largest 9.2e-3); the HSTU bf16 step at (2, 1) against one process: loss
#   1e-4 relative (8.4e-8), parameters as above (mean 2.7e-6).
BF16_LSE_RTOL, BF16_GRAD_RTOL = 1e-6, 2 ** -7
BF16_LOSS_RTOL, BF16_PARAM_MEAN_TOL_A_STEP = 1e-4, 3e-5


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


def _lse_inputs(case: str, bf16: bool = False) -> tp.Dict[str, np.ndarray]:
    """Seeded inputs of an ``LSE_CASES`` (or, ``bf16``, a ``BF16_LSE_CASES``)
    case; bf16 towers come as the f32 values of bf16 numbers."""
    m, n, d = (BF16_LSE_CASES if bf16 else LSE_CASES)[case]
    rng = np.random.default_rng(m + n)
    out = {
        "s": rng.normal(0, 0.5, (m, d)).astype(np.float32),
        "items": rng.normal(0, 0.5, (n, d)).astype(np.float32),
        "g": rng.normal(0, 1.0, (m,)).astype(np.float32),  # mixed-sign lse cotangent
    }
    if bf16:
        for key in ("s", "items"):
            out[key] = torch.from_numpy(out[key]).to(torch.bfloat16).float().numpy()
    return out


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


def _sharded_lse(
    mesh: tp.Any, inputs: tp.Dict[str, np.ndarray], dtype: torch.dtype = torch.float32
) -> tp.Dict[str, np.ndarray]:
    start, stop = port_dist.data_parallel_row_range(inputs["s"].shape[0], mesh)
    s = torch.tensor(inputs["s"][start:stop]).to(dtype).requires_grad_()
    items = torch.tensor(inputs["items"]).to(dtype).requires_grad_()
    lse = softmax_lse.sharded_streaming_lse(s, items, mesh, MODEL_AXIS, data_axis=DATA_AXIS)
    (lse * torch.tensor(inputs["g"][start:stop])).sum().backward()
    assert s.grad.dtype == items.grad.dtype == dtype
    return {"lse": lse.detach().numpy(), "ds": s.grad.float().numpy(), "di": items.grad.float().numpy()}


def _step(model: tp.Any, batch: tp.Dict[str, np.ndarray], init: bool = False) -> tp.Tuple[float, tp.Dict[str, tp.Any]]:
    """The loss of one train step on ``batch`` and the whole parameters after it."""
    tm = model.training_module
    if init:
        tm.init_params()
    loss = float(tm._train_step(tm._device_batch(tm._local_batch(batch))))
    return loss, {k: v.numpy() for k, v in tm.get_state()["params"].items()}


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
    # (h) bf16 compute: the sharded lse on bf16 towers, a (2, 2) step and fit from the converted JAX parameters,
    # and the port's own (2, 2) fit with dropout
    for case, inputs in payload["bf16_lse"].items():
        for shape in ((1, 4), (2, 2)):
            out[f"bf16_lse_{case}_{shape}"] = _sharded_lse(meshes[shape], inputs, torch.bfloat16)
    out["bf16_step"] = _step(_model(df, (2, 2), 0.0, start, **BF16), payload["first"])
    out["bf16_fit_from_jax"] = _fit_summary(_model(df, (2, 2), 0.0, start, **BF16))
    out["bf16_fit_dropout"] = _fit_summary(_model(df, (2, 2), 0.2, **BF16))
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
    # (e) one HSTU step at (2, 1), dropout on, in f32 and with bf16 compute
    out["hstu_loss"], out["hstu_params"] = _step(_model(payload["df"], (2, 1), 0.2, model_cls=HSTUModel),
                                                 payload["hstu_first"], init=True)
    out["hstu_bf16"] = _step(_model(payload["df"], (2, 1), 0.2, model_cls=HSTUModel, **BF16), payload["hstu_first"],
                             init=True)
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
def jax_bf16_mesh_run(jax_mesh_run):
    """The JAX package with bf16 compute at mesh (4, 2), dropout 0, from the
    f32 run's start parameters: one train step on the first batch, and a
    one-epoch fit."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.dataset import Dataset as JaxDataset
    from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel

    model = JaxSASRecModel(
        **CONFIG, dropout_rate=0.0, get_val_mask_func=leave_last_out,
        training_module_kwargs=dict(TRAINING_KWARGS, mesh_shape=(4, 2), **BF16),
    )
    model._build_model_from_dataset(JaxDataset.construct(jax_mesh_run["df"]))
    tm = model.training_module
    tm.init_params(jax_mesh_run["first"])
    start = jax.tree.map(np.array, tm.params)
    same_start = flax_params_to_state_dict(start)  # the seed's parameters, as the f32 run's
    assert all(np.array_equal(same_start[k].numpy(), v) for k, v in jax_mesh_run["start"].items())

    def fresh():
        params = tm._shard_params(jax.tree.map(jnp.array, start))
        return params, tm._make_optimizer().init(params)

    params, opt_state = fresh()
    stepped, _, step_loss = tm._train_step(params, opt_state, tm._device_batch(jax_mesh_run["first"]),
                                           jax.random.PRNGKey(0))
    one_step = (float(step_loss), flax_params_to_state_dict(jax.tree.map(np.array, stepped)))
    tm.params, tm.opt_state = fresh()
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    assert tm.resolved_compute_dtype == "bfloat16"
    return {"one_step": one_step, "train": list(tm.train_loss_history), "val": list(tm.val_loss_history),
            "steps": tm.global_step, "final": flax_params_to_state_dict(jax.tree.map(np.array, tm.params))}


@pytest.fixture(scope="module")
def checkpoint_path(tmp_path_factory):
    """Where rank 0 of the four-rank world writes the (2, 2) fit's training state."""
    return str(tmp_path_factory.mktemp("mesh_checkpoint") / "state.pt")


@pytest.fixture(scope="module")
def four_ranks(jax_mesh_run, checkpoint_path):
    payload = {
        "df": jax_mesh_run["df"], "start": jax_mesh_run["start"], "first": jax_mesh_run["first"],
        "lse": {case: _lse_inputs(case) for case in LSE_CASES}, "checkpoint": checkpoint_path,
        "bf16_lse": {case: _lse_inputs(case, bf16=True) for case in BF16_LSE_CASES},
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
        "bf16_dropout": _fit_summary(_model(df, None, 0.2, **BF16)),
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


# ------------------------------------------------------------------ (h) bf16 compute


@functools.lru_cache(maxsize=None)
def _jax_sharded_lse_bf16(case: str) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lse, ds, di) of the JAX ``sharded_streaming_lse`` on bf16 towers on the
    (2, 4) CPU mesh, in interpret mode; ds and di are bf16 values."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.ops import softmax_lse as jax_softmax_lse
    from rectools_tpu.parallel.mesh import make_mesh as jax_make_mesh

    inputs = _lse_inputs(case, bf16=True)
    mesh = jax_make_mesh(n_data=2, n_model=4)

    def value(s, items):
        return jax_softmax_lse.sharded_streaming_lse(
            s, items, mesh, "model", data_axis="data", block_m=16, chunk_n=32, interpret=True
        )

    s, items = jnp.asarray(inputs["s"], jnp.bfloat16), jnp.asarray(inputs["items"], jnp.bfloat16)
    eds, edi = jax.grad(lambda s_, i_: jnp.sum(value(s_, i_) * inputs["g"]), argnums=(0, 1))(s, items)
    assert eds.dtype == edi.dtype == jnp.bfloat16
    return (np.asarray(value(s, items)), np.asarray(eds.astype(jnp.float32)), np.asarray(edi.astype(jnp.float32)))


def _bf16_rel(got: np.ndarray, expected: np.ndarray) -> float:
    return float(np.abs(got - expected).max() / np.abs(expected).max())


def _to_bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def _bf16_data_rows(results, case: str, shape: tp.Tuple[int, int]) -> tp.List[tp.Dict[str, np.ndarray]]:
    """Each data shard's results of a bf16 sharded-lse case; the ranks of a
    model group agree exactly."""
    where = _by_coords(results, shape)
    key = f"bf16_lse_{case}_{shape}"
    for (d, m), rank in where.items():
        for name in ("lse", "ds", "di"):
            np.testing.assert_array_equal(results[rank][key][name], results[where[(d, 0)]][key][name])
    return [results[where[(d, 0)]][key] for d in range(shape[0])]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("case", sorted(BF16_LSE_CASES))
def test_bf16_sharded_streaming_lse_matches_jax(four_ranks, case: str, shape: tp.Tuple[int, int]) -> None:
    """The mesh loss on bf16 towers (kernels 8-11's bf16 twins, each shard's
    ds rounded to bf16 and summed over the model group in bf16, as JAX's
    transpose does) against JAX's on the (2, 4) mesh: the f32 lse, ds and di
    in bf16 within one bf16 step. The tower gradient's sum over the data group
    is the train step's f32 sum (here in numpy), rounded to bf16 to stand
    beside JAX's bf16 sum (test_bf16_tower_gradient_sums_over_data_in_f32)."""
    expected, eds, edi = _jax_sharded_lse_bf16(case)
    rows = _bf16_data_rows(four_ranks, case, shape)
    lse = np.concatenate([r["lse"] for r in rows])
    ds = np.concatenate([r["ds"] for r in rows])
    di = _to_bf16(sum(r["di"] for r in rows))
    assert np.isfinite(lse).all() and np.array_equal(ds, _to_bf16(ds))
    np.testing.assert_allclose(lse, expected, rtol=BF16_LSE_RTOL, atol=0)
    assert _bf16_rel(ds, eds) <= BF16_GRAD_RTOL
    assert _bf16_rel(di, edi) <= BF16_GRAD_RTOL
    assert di.shape == _lse_inputs(case, bf16=True)["items"].shape


def test_bf16_tower_gradient_sums_over_data_in_f32(four_ranks) -> None:
    """The standing divergence of ROADMAP §3: JAX sums the item tower's bf16
    cotangent over the data axis in bf16 inside ``shard_map``; the port sums
    the f32 parameter gradients over the data group after the cast. With two
    data shards the two differ by JAX's one rounding of each sum: up to half
    a bf16 step of the entry, at most 2^-8 of it (measured: 1.5e-3 on an
    entry of 0.51, 2.9e-3 of the largest entry), and not 0."""
    rows = _bf16_data_rows(four_ranks, "ragged", (2, 2))
    f32_sum = rows[0]["di"] + rows[1]["di"]  # bf16 values, summed in f32 as the port's train step sums them
    bf16_sum = _to_bf16(f32_sum)  # JAX's psum of two bf16 values
    gap = np.abs(f32_sum - bf16_sum)
    assert 0 < gap.max() <= 2 ** -8 * np.abs(bf16_sum).max()
    assert (gap <= 2 ** -8 * np.abs(bf16_sum)).all()


def _assert_bf16_params_close(got: tp.Dict[str, np.ndarray], expected: tp.Mapping[str, tp.Any], steps: int) -> float:
    """Every entry within 2 x steps x lr (a noise-level entry moved by Adam on
    both sides) and the mean over all entries within steps x
    BF16_PARAM_MEAN_TOL_A_STEP; returns the mean."""
    assert set(got) == set(expected)
    diffs = []
    for name, value in got.items():
        assert value.dtype == np.float32, name  # the master weights stay f32
        other = expected[name].numpy() if isinstance(expected[name], torch.Tensor) else expected[name]
        err = np.abs(value - other)
        assert err.max() <= 2 * steps * LR, (name, err.max())
        diffs.append(err.reshape(-1))
    mean = float(np.concatenate(diffs).mean())
    assert mean <= steps * BF16_PARAM_MEAN_TOL_A_STEP
    return mean


def test_bf16_mesh_train_step_matches_jax_mesh(jax_bf16_mesh_run, four_ranks) -> None:
    """One bf16 step at (2, 2) from the converted JAX start against JAX's bf16
    step at (4, 2)."""
    expected_loss, expected_params = jax_bf16_mesh_run["one_step"]
    for result in four_ranks:
        loss, params = result["bf16_step"]
        np.testing.assert_allclose(loss, expected_loss, rtol=BF16_LOSS_RTOL)
        _assert_bf16_params_close(params, expected_params, steps=1)


def test_bf16_mesh_fit_matches_jax_mesh_fit(jax_bf16_mesh_run, four_ranks) -> None:
    """A one-epoch (7-step) bf16 fit at (2, 2) against JAX's bf16 mesh fit at
    (4, 2) from the same start; every rank reports the same fit."""
    for result in four_ranks:
        fit = result["bf16_fit_from_jax"]
        assert fit["steps"] == jax_bf16_mesh_run["steps"] == 7
        assert fit["train"] == four_ranks[0]["bf16_fit_from_jax"]["train"]
        np.testing.assert_allclose(fit["train"], jax_bf16_mesh_run["train"], rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(fit["val"], jax_bf16_mesh_run["val"], rtol=BF16_LOSS_RTOL)
        _assert_bf16_params_close(fit["params"], jax_bf16_mesh_run["final"], steps=fit["steps"])


def test_bf16_mesh_fit_matches_single_process(four_ranks, single_process) -> None:
    """The (2, 2) bf16 fit with dropout against the port's single-process bf16
    fit of the same global batches: column-sharded tables gathered in bf16, the
    loss through kernels 8 and 9's bf16 twins, the parameter gradients summed
    over the data group."""
    expected = single_process["bf16_dropout"]
    for result in four_ranks:
        fit = result["bf16_fit_dropout"]
        assert fit["steps"] == expected["steps"]
        assert fit["ids_emb_shape"][1] == CONFIG["n_factors"] // 2
        np.testing.assert_allclose(fit["train"], expected["train"], rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(fit["val"], expected["val"], rtol=BF16_LOSS_RTOL)
        _assert_bf16_params_close(fit["params"], expected["params"], steps=fit["steps"])
        for name, value in fit["params"].items():
            np.testing.assert_array_equal(value, four_ranks[0]["bf16_fit_dropout"]["params"][name], err_msg=name)


def test_bf16_hstu_mesh_step_matches_single_process(two_ranks) -> None:
    """One HSTU step with bf16 compute at (2, 1) (the bf16 forms of kernels
    17-19 and 8-9 through their twins) against the single-process bf16 step."""
    payload, results = two_ranks
    loss, expected = _step(_model(payload["df"], None, 0.2, model_cls=HSTUModel, **BF16), payload["hstu_first"],
                           init=True)
    for result in results:
        got_loss, got = result["hstu_bf16"]
        np.testing.assert_allclose(got_loss, loss, rtol=BF16_LOSS_RTOL)
        _assert_bf16_params_close(got, expected, steps=1)


def test_failing_rank_fails_the_launch() -> None:
    with pytest.raises(RuntimeError, match="ranks .* failed"):
        run_ranks(failing_worker, 2, timeout_s=120.0, backend="gloo")


def failing_worker(rank: int) -> int:
    if rank == 1:
        raise ValueError("rank 1 gives up")
    # rank 0 waits in a collective that rank 1 never joins: the launcher ends it
    collectives.all_reduce_sum(torch.zeros(1), make_mesh(2, 1).group(DATA_AXIS))
    return rank
