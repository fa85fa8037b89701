"""The port's BERT4Rec (Pre-LN stack, MLM batches, fit, serving), held against
the JAX package on the CPU.

One module-scoped fixture builds a small BERT4Rec (2 blocks, d = 32, L = 20,
about 300 items + PAD + MASK) in the JAX package from one seeded frame, draws
its start parameters, takes one train step and fits one epoch with dropout
0 in f32. The port starts from the same parameters
(``flax_params_to_state_dict``). Tolerances: the Pre-LN backbone 1e-5
absolute; the train, validation and recommend batches bit-equal for the same
``rng``; one train step 1e-5 (loss relative, parameters absolute); one epoch
1e-4; recommend scores 1e-5 relative. The attention key-projection biases are
the one exemption, as in ``test_torch_training.py``: steps * lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn import item_net as jax_item_net
from rectools_tpu.models.nn.transformers import BERT4RecModel as JaxBERT4RecModel
from rectools_tpu.models.nn.transformers import backbone as jax_backbone
from rectools_tpu.models.nn.transformers import bert4rec as jax_bert4rec
from rectools_tpu.models.nn.transformers import net_blocks as jax_net_blocks
from rectools_tpu.models.nn.transformers import similarity as jax_similarity
from rectools_tpu.models.nn.transformers import utils as jax_utils
from rectools_tpu.models.nn.transformers.negative_sampler import CatalogUniformSampler as JaxSampler
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import BERT4RecModel, BERT4RecModelConfig
from rectools_tpu_torch.models.nn import item_net
from rectools_tpu_torch.models.nn.transformers import (
    BERT4RecDataPreparator,
    LearnableInversePositionalEncoding,
    PreLNTransformerLayers,
    TransformerBackbone,
    flax_params_to_state_dict,
    leave_one_out_mask,
    state_dict_to_flax_params,
)
from rectools_tpu_torch.models.nn.transformers.negative_sampler import CatalogUniformSampler
from rectools_tpu_torch.models.nn.transformers.similarity import DistanceSimilarityModule

D, HEADS, BLOCKS, L, N_ITEMS = 32, 2, 2, 12, 50
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


def _random_like(tree, rng: np.random.Generator):
    """Same structure, fresh seeded values (LN scales around 1, all biases nonzero)."""
    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = np.shape(leaf)
        if name == "scale":
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        std = 0.1 if name == "bias" else 1.0 / np.sqrt(shape[0]) if name == "kernel" else 0.5
        return (std * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------------ Pre-LN backbone


def test_pre_ln_backbone_matches_jax() -> None:
    """BERT4Rec's encoder: the Pre-LN stack under a key-padding bias with the
    diagonal kept and no causal mask; left-padded rows, one of length 1."""
    jax_model = jax_backbone.TransformerBackbone(
        item_model=jax_item_net.SumOfEmbeddingsConstructor(
            n_items=N_ITEMS,
            item_net_blocks=(jax_item_net.IdEmbeddingsItemNet(n_items=N_ITEMS, n_factors=D, dropout_rate=0.0),),
        ),
        pos_encoding_layer=jax_net_blocks.LearnableInversePositionalEncoding(
            use_pos_emb=True, session_max_len=L, n_factors=D
        ),
        transformer_layers=jax_net_blocks.PreLNTransformerLayers(
            n_blocks=BLOCKS, n_factors=D, n_heads=HEADS, dropout_rate=0.0
        ),
        similarity_module=jax_similarity.DistanceSimilarityModule(distance="dot"),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=False,
        use_key_padding_mask=True,
    )
    rng = np.random.default_rng(29)
    lengths = rng.integers(1, L + 1, size=6)
    lengths[:2] = (1, L)
    x = rng.integers(1, N_ITEMS, size=(6, L))
    x[np.arange(L)[None, :] < (L - lengths)[:, None]] = 0
    batch = {"x": jnp.asarray(x)}
    params = _random_like(jax_model.init(jax.random.PRNGKey(0), batch)["params"], rng)
    assert set(params["transformer_layers"]["block_0"]) == {
        "layer_norm_1", "multi_head_attn", "layer_norm_2", "feed_forward"}

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
        pos_encoding_layer=LearnableInversePositionalEncoding(True, L, D, device=cpu),
        transformer_layers=PreLNTransformerLayers(BLOCKS, D, HEADS, 0.0, device=cpu),
        similarity_module=DistanceSimilarityModule("dot"),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=False,
        use_key_padding_mask=True,
    ).eval()
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    bias = port._build_attn_bias(torch.from_numpy(x))
    assert bias.shape == (6, 1, L, L) and bias.is_contiguous()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        sessions = port.encode_sessions({"x": xt}, port.item_model.embed_catalog()).numpy()
        logits = port({"x": xt}).numpy()
    assert np.abs(jax_sessions).max() > 0.1
    np.testing.assert_allclose(sessions, jax_sessions, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits, jax_logits, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ batches


@pytest.mark.parametrize("with_negatives", [False, True])
def test_train_validation_and_recommend_batches_equal_jax(with_negatives: bool) -> None:
    """The MLM draw (80% MASK, 10% a random item, 10% kept) and the host
    negatives consume the loader's ``rng`` in the JAX package's order, so the
    batches are bit-equal; validation and recommend append MASK."""
    df = _frame()
    kwargs = dict(session_max_len=20, batch_size=32, get_val_mask_func=leave_last_out, mask_prob=0.3)
    if with_negatives:
        jax_prep = jax_bert4rec.BERT4RecDataPreparator(**kwargs, n_negatives=3, negative_sampler=JaxSampler(3))
        port_prep = BERT4RecDataPreparator(**kwargs, n_negatives=3, negative_sampler=CatalogUniformSampler(3))
    else:
        jax_prep, port_prep = jax_bert4rec.BERT4RecDataPreparator(**kwargs), BERT4RecDataPreparator(**kwargs)
    jax_ds, port_ds = JaxDataset.construct(df), Dataset.construct(df)
    jax_prep.process_dataset_train(jax_ds)
    port_prep.process_dataset_train(port_ds)
    assert port_prep.n_item_extra_tokens == 2 and port_prep.extra_token_ids == {"PAD": 0, "MASK": 1}
    for loader in ("get_dataloader_train", "get_dataloader_val"):
        jax_batches = list(getattr(jax_prep, loader)(np.random.default_rng(np.random.SeedSequence((5, 0)))))
        port_batches = list(getattr(port_prep, loader)(np.random.default_rng(np.random.SeedSequence((5, 0)))))
        assert len(port_batches) == len(jax_batches) > 1
        for got, expected in zip(port_batches, jax_batches):
            assert got.keys() == expected.keys()
            assert ("negatives" in got) == with_negatives
            for key in got:
                np.testing.assert_array_equal(got[key], expected[key])
        x = np.concatenate([b["x"] for b in port_batches])
        assert (x == 1).any()  # MASK in every kind of batch
        if loader == "get_dataloader_val":
            assert (x[:, -1] == 1).all()
        else:  # the 10% branch draws real items only
            y = np.concatenate([b["y"] for b in port_batches])
            random_items = x[(y != 0) & (x != y) & (x != 1)]
            assert len(random_items) > 0 and random_items.min() >= 2
    users = np.unique(df[Columns.User])[::3]
    jax_rec = list(jax_prep.get_dataloader_recommend(jax_prep.transform_dataset_u2i(jax_ds, users), 16))
    port_rec = list(port_prep.get_dataloader_recommend(port_prep.transform_dataset_u2i(port_ds, users), 16))
    assert len(port_rec) == len(jax_rec) > 1
    for got, expected in zip(port_rec, jax_rec):
        np.testing.assert_array_equal(got["x"], expected["x"])
        assert (got["x"][:, -1] == 1).all()


def test_mask_draw_shares_and_range() -> None:
    """Over 200,000 tokens: 15% masked, of which 80% become MASK and 10% a
    random item from [n_extra_tokens, n_items); the random draw never yields
    PAD or MASK."""
    prep = BERT4RecDataPreparator(session_max_len=20, batch_size=32, mask_prob=0.15)
    prep.process_dataset_train(Dataset.construct(_frame()))
    tokens = np.random.default_rng(1).integers(2, prep.item_id_map.size, size=200_000)
    x, y = prep._mask_tokens(tokens, np.random.default_rng(2))
    masked = y != 0
    assert abs(masked.mean() - 0.15) < 0.005
    assert abs((x[masked] == 1).mean() - 0.8) < 0.01
    assert np.array_equal(y[masked], tokens[masked]) and (x[~masked] == tokens[~masked]).all()
    changed = masked & (x != 1) & (x != tokens)
    assert changed.any() and x[changed].min() >= 2 and x[changed].max() < prep.item_id_map.size


# ------------------------------------------------------------------ fit


@pytest.fixture(scope="module")
def jax_run():
    df = _frame()
    model = JaxBERT4RecModel(
        **CONFIG, dropout_rate=0.0, get_val_mask_func=leave_last_out, training_module_kwargs=TRAINING_KWARGS
    )
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)
    params, opt_state = jax.tree.map(jnp.array, start), tm._make_optimizer().init(jax.tree.map(jnp.array, start))
    stepped, _, step_loss = tm._train_step(params, opt_state, {k: jnp.asarray(v) for k, v in first.items()},
                                           jax.random.PRNGKey(0))
    one_step = (float(step_loss), jax.tree.map(np.array, stepped))
    tm.params, tm.opt_state = jax.tree.map(jnp.array, start), tm._make_optimizer().init(jax.tree.map(jnp.array, start))
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    model.is_fitted = True
    return {"df": df, "start": start, "first": first, "one_step": one_step, "tm": tm, "model": model,
            "final": jax.tree.map(np.array, tm.params)}


def _port_model(df: pd.DataFrame, start, **kwargs) -> BERT4RecModel:
    model = BERT4RecModel(
        **CONFIG, dropout_rate=0.0, get_val_mask_func=leave_last_out, training_module_kwargs=TRAINING_KWARGS,
        device="cpu", **kwargs,
    )
    model._build_model_from_dataset(Dataset.construct(df))
    model.training_module.load_params(flax_params_to_state_dict(start))
    return model


def _assert_params_close(model: BERT4RecModel, jax_params, atol: float, steps: int) -> None:
    expected = flax_params_to_state_dict(jax_params)
    port_state = model.backbone.state_dict()
    assert set(port_state) == set(expected)
    for name, value in port_state.items():
        tol = steps * LR if name.endswith("multi_head_attn.k_proj.bias") else atol
        err = (value - expected[name]).abs().max().item()
        assert err <= tol, (name, err)


def test_state_dict_round_trips_the_pre_ln_tree(jax_run) -> None:
    state = flax_params_to_state_dict(jax_run["start"])
    n_rows = jax_run["model"].data_preparator.item_id_map.size
    assert state["item_model.item_net_blocks.0.ids_emb.weight"].shape[0] == n_rows
    block = jax_run["start"]["transformer_layers"]["block_1"]
    assert torch.equal(state["transformer_layers.blocks.1.feed_forward.ff_linear_1.weight"],
                       torch.from_numpy(block["feed_forward"]["ff_linear_1"]["kernel"].T))
    assert torch.equal(state["transformer_layers.blocks.1.layer_norm_2.scale"],
                       torch.from_numpy(block["layer_norm_2"]["scale"]))
    jax.tree.map(np.testing.assert_array_equal, state_dict_to_flax_params(state), jax_run["start"])


def test_one_train_step_matches_jax(jax_run) -> None:
    model = _port_model(jax_run["df"], jax_run["start"])
    tm = model.training_module
    assert tm._use_fused_softmax and tm.backbone.item_model.n_items == model.data_preparator.item_id_map.size
    loss = tm._train_step(tm._device_batch(jax_run["first"]))
    expected_loss, expected_params = jax_run["one_step"]
    np.testing.assert_allclose(loss.item(), expected_loss, rtol=1e-5)
    _assert_params_close(model, expected_params, atol=1e-5, steps=1)


def test_one_epoch_fit_matches_jax(jax_run) -> None:
    model = _port_model(jax_run["df"], jax_run["start"])
    tm, jax_tm = model.training_module, jax_run["tm"]
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    assert tm.global_step == jax_tm.global_step > 1
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=1e-4)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=1e-4)
    np.testing.assert_allclose(tm.val_metric_history["val_recall@5"], jax_tm.val_metric_history["val_recall@5"])
    _assert_params_close(model, jax_run["final"], atol=1e-4, steps=tm.global_step)


def test_recommend_matches_jax(jax_run) -> None:
    """Serving from the JAX fit's parameters: the same items and scores, and
    neither PAD nor MASK among them."""
    df = jax_run["df"]
    model = BERT4RecModel(**CONFIG, device="cpu").load_jax_params(Dataset.construct(df), jax_run["final"])
    users = np.unique(df[Columns.User])[:40]
    got = model.recommend(users, Dataset.construct(df), k=5, filter_viewed=True)
    expected = jax_run["model"].recommend(users, JaxDataset.construct(df), k=5, filter_viewed=True)
    assert len(got) == len(expected) == 5 * len(users)
    assert not got[Columns.Item].isin(["PAD", "MASK"]).any()
    np.testing.assert_allclose(got[Columns.Score].to_numpy(), expected[Columns.Score].to_numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got[Columns.User].to_numpy(), expected[Columns.User].to_numpy())
    same_item = got[Columns.Item].to_numpy() == expected[Columns.Item].to_numpy()
    assert same_item.mean() > 0.95  # near-equal scores may swap places


def test_batch_without_masked_positions_gives_zero_loss_and_gradients(jax_run) -> None:
    """A batch whose MLM draw masked nothing (y = 0 everywhere): a loss of 0
    and zero gradients, not NaN, on both sides."""
    batch = {**jax_run["first"], "y": np.zeros_like(jax_run["first"]["y"])}
    jax_tm = jax_run["tm"]
    start = jax.tree.map(jnp.asarray, jax_run["start"])
    jax_loss, jax_grads = jax.value_and_grad(jax_tm._fused_softmax_loss_value)(
        start, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    assert float(jax_loss) == 0.0
    assert all(np.all(np.asarray(g) == 0) for g in jax.tree.leaves(jax_grads))
    model = _port_model(jax_run["df"], jax_run["start"])
    tm = model.training_module
    loss = tm._train_step(tm._device_batch(batch))
    assert loss.item() == 0.0
    for name, param in model.backbone.named_parameters():
        assert param.grad is not None and torch.isfinite(param.grad).all() and not param.grad.any(), name
    _assert_params_close(model, jax_run["start"], atol=0.0, steps=0)  # Adam moves nothing on zero gradients


def test_mask_prob_one_trains_and_serves() -> None:
    df = _frame()
    model = BERT4RecModel(**{**CONFIG, "epochs": 2}, mask_prob=1.0, device="cpu").fit(Dataset.construct(df))
    losses = model.training_module.train_loss_history
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    reco = model.recommend(np.unique(df[Columns.User])[:10], Dataset.construct(df), k=3, filter_viewed=False)
    assert len(reco) == 30 and np.isfinite(reco[Columns.Score].to_numpy()).all()


@pytest.mark.parametrize("loss", ["BCE", "sampled_softmax"])
def test_device_negatives_skip_pad_and_mask(loss: str) -> None:
    model = BERT4RecModel(**CONFIG, loss=loss, n_negatives=50, device="cpu")
    model._build_model_from_dataset(Dataset.construct(_frame()))
    tm = model.training_module
    y = torch.ones((32, CONFIG["session_max_len"]), dtype=torch.int64)
    negatives = tm._negatives({"y": y}, (7, 11))
    assert negatives.min().item() == 2 and negatives.max().item() == tm.backbone.item_model.n_items - 1


# ------------------------------------------------------------------ config, validation mask


def test_config_round_trip_and_defaults_match_jax() -> None:
    model = BERT4RecModel(n_factors=64, mask_prob=0.3, transformer_layers_kwargs={"ff_factors_multiplier": 2},
                          device="cpu")
    config = model.get_config()
    assert config["cls"] is BERT4RecModel and config["mask_prob"] == 0.3
    assert config["transformer_layers_type"] is PreLNTransformerLayers
    restored = BERT4RecModel.from_config(config)
    assert restored.get_config() == config and restored.data_preparator.mask_prob == 0.3
    simple = model.get_config(simple_types=True)
    assert simple["transformer_layers_type"].endswith("net_blocks.PreLNTransformerLayers")
    assert BERT4RecModel.from_config(simple).get_config() == config
    assert isinstance(model.get_config(mode="pydantic"), BERT4RecModelConfig)
    layers = restored._init_transformer_layers()
    assert layers.blocks[0].feed_forward.ff_linear_1.out_features == 128
    defaults, jax_defaults = BERT4RecModel(device="cpu").get_config(), JaxBERT4RecModel().get_config()
    for key in ("mask_prob", "use_key_padding_mask", "use_causal_attn", "n_factors", "n_heads", "n_blocks",
                "dropout_rate", "session_max_len", "loss", "batch_size", "lr", "epochs"):
        assert defaults[key] == jax_defaults[key], key
    assert not defaults["use_causal_attn"] and defaults["use_key_padding_mask"]


@pytest.mark.parametrize("val_users", [None, "list", 7])
def test_leave_one_out_mask_matches_jax(val_users) -> None:
    df = _frame()
    if val_users == "list":
        val_users = list(np.unique(df[Columns.User])[::5])
    np.random.seed(3)
    expected = jax_utils.leave_one_out_mask(df, val_users)
    np.random.seed(3)
    got = leave_one_out_mask(df, val_users)
    np.testing.assert_array_equal(got, expected)
    assert got.dtype == bool and 0 < got.sum() <= df[Columns.User].nunique()
