"""The port's HSTU (serve with context, fit), held against the JAX package on
the CPU.

Parameters come from the JAX package (its own init, or seeded numpy values in
its flax layout) and go into the port through ``flax_params_to_state_dict``;
the same frames, sessions and timestamps go through both. On the CPU the JAX
layer takes its dense branch and the port its plain twins. Timestamps in
these frames stay within 10^6 s, and ``test_frame_buckets_equal_jax`` shows
that every difference the frames produce gets the same bucket on both sides.

Tolerances: backbone output 1e-4 absolute (as for SASRec); recommend scores
rtol 1e-5 / atol 1e-4 with equal items wherever neighbouring scores are more
than 1e-4 apart; one train step 1e-5 (loss relative, parameters absolute);
one epoch 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn import item_net as jax_item_net
from rectools_tpu.models.nn.transformers import HSTUModel as JaxHSTUModel
from rectools_tpu.models.nn.transformers import backbone as jax_backbone
from rectools_tpu.models.nn.transformers import hstu as jax_hstu
from rectools_tpu.models.nn.transformers import net_blocks as jax_net_blocks
from rectools_tpu.models.nn.transformers import similarity as jax_similarity
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu.ops.stu_attention import _bucket
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.dataset.context import get_context
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn import item_net
from rectools_tpu_torch.models.nn.transformers import (
    LearnableInversePositionalEncoding,
    STULayers,
    TransformerBackbone,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from rectools_tpu_torch.models.nn.transformers.similarity import DistanceSimilarityModule
from rectools_tpu_torch.ops import stu_attention

D, HEADS, BLOCKS, L, N_ITEMS = 32, 2, 2, 16, 50
CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5)
TRAINING_KWARGS = {"fused_softmax_chunk": 64, "val_recall_k": 5}
TIE_GAP = 1e-4
BIASES = [(True, True), (False, False)]


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
    ).astype({Columns.Datetime: "datetime64[ns]"})  # the unit the JAX package's unix seconds assume


def _context(df: pd.DataFrame) -> pd.DataFrame:
    """One later timestamp per user, through the port's ``get_context``."""
    users = np.unique(df[Columns.User])
    rng = np.random.default_rng(41)
    later = pd.Timestamp("2021-01-13") + pd.to_timedelta(rng.integers(0, 10**5, len(users)), unit="s")
    frame = pd.DataFrame({Columns.User: users, Columns.Item: 0, Columns.Datetime: later})
    return get_context(frame.astype({Columns.Datetime: "datetime64[ns]"}))


def leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


def _random_like(tree, rng: np.random.Generator):
    """Same structure, fresh seeded values (LN scales around 1, all biases and tables nonzero)."""
    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = np.shape(leaf)
        if name == "scale":
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        if name in ("bias", "time_weights", "pos_weights"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        std = 1.0 / np.sqrt(shape[0]) if name in ("kernel", "uvqk_proj") else 0.5
        return (std * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, tree))


def _sessions(rng: np.random.Generator, b: int) -> tuple:
    """Left-padded sessions (B, L) and their (B, L + 1) timestamps, the padding
    filled with the first real one as the preparator does."""
    lengths = rng.integers(1, L + 1, size=b)
    lengths[0] = L
    x = rng.integers(1, N_ITEMS, size=(b, L))
    pad = np.arange(L)[None, :] < (L - lengths)[:, None]
    x[pad] = 0
    ts = 1_600_000_000 + np.sort(rng.integers(0, 10**6, size=(b, L + 1)), axis=1)
    first = ts[np.arange(b), L - lengths]
    ts[:, :L] = np.where(pad, first[:, None], ts[:, :L])
    return x, ts.astype(np.int64)


# ------------------------------------------------------------------ backbone


@pytest.mark.parametrize(
    "use_time,use_pos,key_padding",
    [(True, True, False), (True, False, False), (False, True, False), (False, False, False), (True, True, True)],
)
def test_backbone_matches_jax(use_time: bool, use_pos: bool, key_padding: bool) -> None:
    jax_model = jax_backbone.TransformerBackbone(
        item_model=jax_item_net.SumOfEmbeddingsConstructor(
            n_items=N_ITEMS,
            item_net_blocks=(jax_item_net.IdEmbeddingsItemNet(n_items=N_ITEMS, n_factors=D, dropout_rate=0.0),),
        ),
        pos_encoding_layer=jax_net_blocks.LearnableInversePositionalEncoding(
            use_pos_emb=True, session_max_len=L, n_factors=D, use_scale_factor=True
        ),
        transformer_layers=jax_hstu.STULayers(
            n_blocks=BLOCKS, n_factors=D, n_heads=HEADS, linear_hidden_dim=D // HEADS, attention_dim=D // HEADS,
            session_max_len=L, relative_time_attention=use_time, relative_pos_attention=use_pos, dropout_rate=0.0,
        ),
        similarity_module=jax_similarity.DistanceSimilarityModule(distance="cosine"),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=True,
        use_key_padding_mask=key_padding,
    )
    rng = np.random.default_rng(17)
    x, ts = _sessions(rng, 6)
    batch = {"x": jnp.asarray(x), "unix_ts": jnp.asarray(ts.astype(np.int32))}
    params = _random_like(jax_model.init(jax.random.PRNGKey(0), batch)["params"], rng)
    block = params["transformer_layers"]["block_0"]
    assert block["uvqk_proj"].shape == (D, 4 * D)
    assert ("time_weights" in block.get("rel_attn", {})) == use_time
    assert ("pos_weights" in block.get("rel_attn", {})) == use_pos

    def encode(module, batch):
        return module.encode_sessions(batch, module.item_model.embed_catalog())

    jparams = jax.tree.map(jnp.asarray, params)
    jax_sessions = np.asarray(jax_model.apply({"params": jparams}, batch, method=encode))
    jax_logits = np.asarray(jax_model.apply({"params": jparams}, batch))

    cpu = torch.device("cpu")
    port = TransformerBackbone(
        item_model=item_net.SumOfEmbeddingsConstructor(
            N_ITEMS, [item_net.IdEmbeddingsItemNet(N_ITEMS, D, 0.0, device=cpu)]
        ),
        pos_encoding_layer=LearnableInversePositionalEncoding(True, L, D, use_scale_factor=True, device=cpu),
        transformer_layers=STULayers(
            BLOCKS, D, HEADS, D // HEADS, D // HEADS, L, use_time, use_pos, dropout_rate=0.0, device=cpu
        ),
        similarity_module=DistanceSimilarityModule("cosine"),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=True,
        use_key_padding_mask=key_padding,
    ).eval()
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        port_batch = {"x": torch.from_numpy(x), "unix_ts": torch.from_numpy(ts)}  # int64, as the preparator hands them
        sessions = port.encode_sessions(port_batch, port.item_model.embed_catalog()).numpy()
        logits = port(port_batch).numpy()
    assert np.abs(jax_sessions).max() > 0.1
    assert not sessions[1:][x[1:] == 0].any()  # padded positions come out as zeros
    np.testing.assert_allclose(sessions, jax_sessions, atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits, jax_logits, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ fit


def _jax_model(use_time: bool, use_pos: bool, **kwargs) -> JaxHSTUModel:
    return JaxHSTUModel(
        **CONFIG, dropout_rate=0.0, relative_time_attention=use_time, relative_pos_attention=use_pos,
        training_module_kwargs=TRAINING_KWARGS, **kwargs,
    )


def _port_model(df: pd.DataFrame, start, use_time: bool, use_pos: bool, **kwargs) -> HSTUModel:
    model = HSTUModel(
        **CONFIG, dropout_rate=0.0, relative_time_attention=use_time, relative_pos_attention=use_pos,
        training_module_kwargs=TRAINING_KWARGS, device="cpu", **kwargs,
    )
    model._build_model_from_dataset(Dataset.construct(df))
    model.training_module.load_params(flax_params_to_state_dict(start))
    return model


@pytest.fixture(scope="module", params=BIASES, ids=["time_pos", "no_bias"])
def jax_run(request):
    use_time, use_pos = request.param
    df = _frame()
    model = _jax_model(use_time, use_pos, get_val_mask_func=leave_last_out)
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    assert ("unix_ts" in first) == use_time
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
    return {"df": df, "biases": (use_time, use_pos), "start": start, "first": first, "one_step": one_step, "tm": tm,
            "grads": flax_params_to_state_dict(jax.tree.map(np.array, grads)),
            "final": jax.tree.map(np.array, tm.params)}


def _assert_params_close(model: HSTUModel, jax_params, atol: float, first_step_grads=None) -> None:
    """Every parameter entry within ``atol`` of JAX's; HSTU has no parameter
    whose gradient is zero in exact arithmetic, so none is exempted by name.
    After the first Adam step alone (``first_step_grads``: JAX's gradients), an
    entry moves by lr * g / (|g| + eps): where |g| is within 100 eps = 1e-6 the
    quotient amplifies the gradient's rounding, so those few entries are held
    to 0.1 lr = 1e-4 and counted."""
    expected = flax_params_to_state_dict(jax_params)
    port_state = model.backbone.state_dict()
    assert set(port_state) == set(expected)
    n_entries = n_loose = 0
    for name, value in port_state.items():
        err = (value - expected[name]).abs()
        if first_step_grads is not None:
            loose = first_step_grads[name].abs() < 1e-6
            assert not loose.any() or err[loose].max().item() <= 1e-4, name
            n_entries, n_loose = n_entries + err.numel(), n_loose + int(((err > atol) & loose).sum())
            err = err[~loose]
        assert err.max().item() <= atol, (name, err.max().item())
    assert n_loose <= 1e-4 * max(n_entries, 1)


def test_converter_round_trips_the_hstu_tree(jax_run) -> None:
    use_time, use_pos = jax_run["biases"]
    state = flax_params_to_state_dict(jax_run["start"])
    block = jax_run["start"]["transformer_layers"]["block_1"]
    # the raw (in, out) projection is not transposed; a Dense kernel is
    assert torch.equal(state["transformer_layers.blocks.1.uvqk_proj"], torch.from_numpy(block["uvqk_proj"]))
    assert torch.equal(
        state["transformer_layers.blocks.1.output_mlp.weight"], torch.from_numpy(block["output_mlp"]["kernel"].T)
    )
    assert ("transformer_layers.blocks.1.rel_attn.time_weights" in state) == use_time
    assert ("transformer_layers.blocks.1.rel_attn.pos_weights" in state) == use_pos
    for norm in ("norm_input", "norm_attn_output"):
        assert state[f"transformer_layers.blocks.0.{norm}.scale"].shape == (CONFIG["n_factors"],)
    back = state_dict_to_flax_params(state)
    jax.tree.map(np.testing.assert_array_equal, back, jax_run["start"])
    model = _port_model(jax_run["df"], back, use_time, use_pos)
    for name, value in model.backbone.state_dict().items():
        assert torch.equal(value, state[name])


def test_one_train_step_matches_jax(jax_run) -> None:
    model = _port_model(jax_run["df"], jax_run["start"], *jax_run["biases"], get_val_mask_func=leave_last_out)
    tm = model.training_module
    assert tm._use_fused_softmax  # the cosine towers go through the fused softmax-CE
    loss = tm._train_step(tm._device_batch(jax_run["first"]))
    expected_loss, expected_params = jax_run["one_step"]
    np.testing.assert_allclose(loss.item(), expected_loss, rtol=1e-5)
    _assert_params_close(model, expected_params, atol=1e-5, first_step_grads=jax_run["grads"])
    moved = flax_params_to_state_dict(jax_run["start"])
    for name, value in model.backbone.state_dict().items():
        if name.endswith(("time_weights", "pos_weights", "uvqk_proj")):
            assert (value - moved[name]).abs().max().item() > 1e-4, name  # the step reached the tables


def test_one_epoch_fit_matches_jax(jax_run) -> None:
    model = _port_model(jax_run["df"], jax_run["start"], *jax_run["biases"], get_val_mask_func=leave_last_out)
    tm, jax_tm = model.training_module, jax_run["tm"]
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    assert tm.global_step == jax_tm.global_step == 7
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=1e-4)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=1e-4)
    assert tm.val_metric_history.keys() == jax_tm.val_metric_history.keys() == {"val_recall@5"}
    np.testing.assert_allclose(tm.val_metric_history["val_recall@5"], jax_tm.val_metric_history["val_recall@5"])
    _assert_params_close(model, jax_run["final"], atol=1e-4)


def test_train_batches_equal_jax(jax_run) -> None:
    use_time, use_pos = jax_run["biases"]
    port = _port_model(jax_run["df"], jax_run["start"], use_time, use_pos, get_val_mask_func=leave_last_out)
    jax_prep = jax_run["tm"].data_preparator
    for loader in ("get_dataloader_train", "get_dataloader_val"):
        got_batches = list(getattr(port.data_preparator, loader)(np.random.default_rng(3)))
        jax_batches = list(getattr(jax_prep, loader)(np.random.default_rng(3)))
        assert len(got_batches) == len(jax_batches) > 1
        for got, expected in zip(got_batches, jax_batches):
            assert got.keys() == expected.keys() and ("unix_ts" in got) == use_time
            for key in got:
                np.testing.assert_array_equal(got[key], expected[key])


def test_frame_buckets_equal_jax() -> None:
    """Every timestamp difference the frame's train, validation and recommend
    batches produce gets the same bucket from the port's integer thresholds
    and from JAX's float formula (jitted, as the model runs it)."""
    df = _frame()
    model = HSTUModel(**CONFIG, get_val_mask_func=leave_last_out, device="cpu")
    model._build_model_from_dataset(Dataset.construct(df))
    prep = model.data_preparator
    l = CONFIG["session_max_len"]
    batches = list(prep.get_dataloader_train(np.random.default_rng(0))) + list(prep.get_dataloader_val())
    reco_ds = prep.transform_dataset_u2i(Dataset.construct(df), np.unique(df[Columns.User]), _context(df))
    batches += list(prep.get_dataloader_recommend(reco_ds, 64))
    jax_bucket = jax.jit(lambda d: _bucket(d, 128))
    n, top = 0, 0
    for batch in batches:
        ts = np.concatenate([batch["unix_ts"], batch["unix_ts"][:, -1:]], axis=1)
        assert ts.shape[1] == l + 2 and ts.dtype == np.int64
        got = stu_attention.time_buckets(torch.from_numpy(ts), l, 128).numpy()
        ts32 = ts.astype(np.int32)
        diff = ts32[:, 1 : l + 1, None] - ts32[:, None, :l]
        np.testing.assert_array_equal(got, np.asarray(jax_bucket(jnp.asarray(diff))))
        n, top = n + diff.size, max(top, int(got.max()))
    assert n > 100_000 and top > 40


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
def test_unix_ts_are_seconds_whatever_the_frames_unit(unit: str) -> None:
    """pandas keeps the unit a datetime column was built with; the batches'
    ``unix_ts`` are whole unix seconds for each of them."""
    df = _frame().astype({Columns.Datetime: f"datetime64[{unit}]"})
    model = HSTUModel(**CONFIG, device="cpu")
    model._build_model_from_dataset(Dataset.construct(df))
    assert model.data_preparator.train_dataset.interactions.df[Columns.Datetime].dtype == f"datetime64[{unit}]"
    ts = next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0))))["unix_ts"]
    start = int(pd.Timestamp("2021-01-01").timestamp())
    assert ts.dtype == np.int64 and ts.min() >= start and ts.max() < start + 10**6
    assert (np.diff(ts, axis=1) >= 0).all() and np.diff(ts, axis=1).max() > 10_000


# ------------------------------------------------------------------ recommend


def _assert_reco_close(got: pd.DataFrame, expected: pd.DataFrame) -> None:
    assert list(got.columns) == list(expected.columns)
    np.testing.assert_array_equal(got[Columns.User].to_numpy(), expected[Columns.User].to_numpy())
    np.testing.assert_array_equal(got[Columns.Rank].to_numpy(), expected[Columns.Rank].to_numpy())
    np.testing.assert_allclose(got[Columns.Score].to_numpy(), expected[Columns.Score].to_numpy(), rtol=1e-5, atol=1e-4)
    n_compared = 0
    for _, rows in expected.groupby(Columns.User, sort=False):
        scores = rows[Columns.Score].to_numpy()
        gap = np.abs(np.diff(scores))
        separated = np.ones(len(scores), bool)
        separated[1:] &= gap > TIE_GAP
        separated[:-1] &= gap > TIE_GAP
        pos = rows.index.to_numpy()[separated]
        np.testing.assert_array_equal(got.loc[pos, Columns.Item].to_numpy(), expected.loc[pos, Columns.Item].to_numpy())
        n_compared += len(pos)
    assert n_compared > 0.8 * len(expected)


@pytest.fixture(scope="module")
def served():
    """A JAX HSTU with time and position bias whose parameters, moved off their
    init by seeded values, are loaded into the port."""
    df = _frame()
    jax_ds = JaxDataset.construct(df)
    jax_model = _jax_model(True, True)
    jax_model._build_model_from_dataset(jax_ds)
    tm = jax_model.training_module
    first = jax_pad_batch(next(iter(jax_model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    params = _random_like(tm.params, np.random.default_rng(23))
    tm.params = jax.tree.map(jnp.asarray, params)
    tm.is_fitted = jax_model.is_fitted = True
    port_ds = Dataset.construct(df)
    port_model = HSTUModel(
        **CONFIG, relative_time_attention=True, relative_pos_attention=True, recommend_batch_size=64, device="cpu"
    ).load_jax_params(port_ds, params)
    return df, jax_model, jax_ds, port_model, port_ds


def test_recommend_with_context_matches_jax(served) -> None:
    df, jax_model, jax_ds, port_model, port_ds = served
    users = np.unique(df[Columns.User])
    context = _context(df)
    expected = jax_model.recommend(users, jax_ds, k=5, filter_viewed=True, context=context)
    got = port_model.recommend(users, port_ds, k=5, filter_viewed=True, context=context)
    assert len(got) == 5 * len(users)
    _assert_reco_close(got, expected)
    seen = set(zip(df[Columns.User], df[Columns.Item]))
    assert not any(pair in seen for pair in zip(got[Columns.User], got[Columns.Item]))
    # the context matters: a much later one changes the scores
    later = context.assign(**{Columns.Datetime: context[Columns.Datetime] + pd.Timedelta(days=300)})
    moved = port_model.recommend(users, port_ds, k=5, filter_viewed=True, context=later)
    assert np.abs(moved[Columns.Score].to_numpy() - got[Columns.Score].to_numpy()).max() > 1e-3


def test_recommend_without_context_raises(served) -> None:
    df, _, _, port_model, port_ds = served
    assert port_model.require_recommend_context
    with pytest.raises(ValueError, match="context"):
        port_model.recommend(np.unique(df[Columns.User])[:3], port_ds, k=2, filter_viewed=False)
    with pytest.raises(ValueError, match="No context for some target users"):
        port_model.recommend([0, 1], port_ds, k=2, filter_viewed=False, context=_context(df).iloc[1:])


def test_no_time_attention_needs_no_context() -> None:
    df = _frame()
    dataset = Dataset.construct(df)
    model = HSTUModel(**{**CONFIG, "epochs": 2}, relative_time_attention=False, device="cpu").fit(dataset)
    assert not model.require_recommend_context and not model.data_preparator.add_unix_ts
    losses = model.training_module.train_loss_history
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    reco = model.recommend(np.unique(df[Columns.User])[:10], dataset, k=3, filter_viewed=False)
    assert len(reco) == 30 and np.isfinite(reco[Columns.Score]).all()


def test_hstu_defaults_match_jax() -> None:
    port, ref = HSTUModel(device="cpu"), JaxHSTUModel()
    layers = port._init_transformer_layers()
    block = layers.blocks[0]
    assert block.attention_dim == block.linear_hidden_dim == ref.n_factors // ref.n_heads == 64
    assert tuple(block.uvqk_proj.shape) == (256, 4 * 256)
    assert tuple(block.rel_attn.time_weights.shape) == (129,) and tuple(block.rel_attn.pos_weights.shape) == (199,)
    assert port._init_similarity_module().distance == ref._init_similarity_module().distance == "cosine"
    assert port._init_pos_encoding_layer().use_scale_factor and port.data_preparator.add_unix_ts
    assert port.use_causal_attn and port.get_config()["relative_time_attention"]
    assert HSTUModel.from_config(port.get_config()).relative_pos_attention
    # heads of 8 train in bf16 too (kernels 17-19's bf16 forms at dims of 8)
    narrow = HSTUModel(**{**CONFIG, "n_factors": 16}, training_module_kwargs={"compute_dtype": "bfloat16"},
                       device="cpu").fit(Dataset.construct(_frame()))
    assert narrow.training_module.resolved_compute_dtype == "bfloat16"
    assert np.isfinite(narrow.training_module.train_loss_history).all()


def test_init_redraws_tables_and_projection_from_the_seed() -> None:
    """Xavier-normal for the 2-D ``uvqk_proj``; the 1-D tables keep N(0, 0.02),
    as the JAX package's re-init leaves them; the seed fixes all of them."""
    states = []
    for _ in range(2):
        model = HSTUModel(n_blocks=1, n_heads=2, n_factors=128, session_max_len=50, seed=3, device="cpu")
        model._build_model_from_dataset(Dataset.construct(_frame()))
        model.training_module.init_params()
        states.append(model.backbone.state_dict())
    for (name, a), b in zip(states[0].items(), states[1].values()):
        assert torch.equal(a, b), name
    proj = states[0]["transformer_layers.blocks.0.uvqk_proj"]
    assert abs(proj.std().item() / np.sqrt(2.0 / (128 + 512)) - 1) < 0.05
    for table in ("time_weights", "pos_weights"):
        std = states[0][f"transformer_layers.blocks.0.rel_attn.{table}"].std().item()
        assert 0.012 < std < 0.03, (table, std)


# ------------------------------------------------------------------ the recommend batch keeps its timestamps


def test_recommend_passes_the_whole_batch_to_the_encoder(monkeypatch: pytest.MonkeyPatch) -> None:
    """The recommend collate builds ``unix_ts`` beside ``x``; both must reach
    ``encode_sessions``, on the model's device. (An encoder handed ``x`` alone
    cannot serve a time-aware layer; SASRec never reads the timestamps, so only
    this check notices.)"""
    df = _frame()
    dataset = Dataset.construct(df)
    model = SASRecModel(
        n_blocks=1, n_heads=2, n_factors=16, session_max_len=10, batch_size=64, epochs=1,
        data_preparator_kwargs={"add_unix_ts": True}, recommend_batch_size=64, device="cpu",
    ).fit(dataset)
    seen = []
    encode = model.backbone.encode_sessions

    def spy(batch, item_embs):
        seen.append({key: (tuple(value.shape), value.dtype, value.device.type) for key, value in batch.items()})
        return encode(batch, item_embs)

    monkeypatch.setattr(model.backbone, "encode_sessions", spy)
    users = np.unique(df[Columns.User])
    reco = model.recommend(users, dataset, k=3, filter_viewed=False)
    assert len(reco) == 3 * len(users) and len(seen) == 4
    for keys in seen:
        assert set(keys) == {"x", "unix_ts"}
        assert keys["unix_ts"] == ((keys["x"][0][0], 11), torch.int64, "cpu")
