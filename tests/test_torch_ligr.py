"""The port's LiGR layers (eSASRec), its feed-forwards and its shared-negative
logits, held against the JAX package on the CPU.

Parameters are drawn from a seed with numpy in the JAX package's flax layout,
go into the JAX modules as they are and into the port through
``flax_params_to_state_dict``; the same sessions go through both, dropout
off. Tolerances: the LiGR backbone 1e-5 absolute, the feed-forwards 1e-6, the
shared-negative logits for one injected (B, K) negative set 1e-5, one epoch
of eSASRec with host-drawn negatives 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn import dropout as jax_dropout
from rectools_tpu.models.nn import item_net as jax_item_net
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu.models.nn.transformers import backbone as jax_backbone
from rectools_tpu.models.nn.transformers import ligr as jax_ligr
from rectools_tpu.models.nn.transformers import net_blocks as jax_net_blocks
from rectools_tpu.models.nn.transformers import similarity as jax_similarity
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import SASRecModel
from rectools_tpu_torch.models.nn import item_net
from rectools_tpu_torch.models.nn.transformers import (
    LearnableInversePositionalEncoding,
    LiGRLayers,
    SwigluFeedForward,
    TransformerBackbone,
    flax_params_to_state_dict,
    init_feed_forward,
)
from rectools_tpu_torch.models.nn.transformers import training as port_tm_module
from rectools_tpu_torch.models.nn.transformers.similarity import DistanceSimilarityModule

D, HEADS, BLOCKS, L, N_ITEMS = 32, 2, 2, 12, 50
CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5)
N_NEGATIVES = 6


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


def _sessions(rng: np.random.Generator, b: int) -> np.ndarray:
    lengths = rng.integers(1, L + 1, size=b)
    x = rng.integers(1, N_ITEMS, size=(b, L))
    x[np.arange(L)[None, :] < (L - lengths)[:, None]] = 0  # left padding
    return x


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


@pytest.mark.parametrize("ff_activation,bias_in_ff", [("swiglu", False), ("gelu", True), ("relu", False)])
def test_ligr_backbone_matches_jax(ff_activation: str, bias_in_ff: bool) -> None:
    jax_model = jax_backbone.TransformerBackbone(
        item_model=jax_item_net.SumOfEmbeddingsConstructor(
            n_items=N_ITEMS,
            item_net_blocks=(jax_item_net.IdEmbeddingsItemNet(n_items=N_ITEMS, n_factors=D, dropout_rate=0.0),),
        ),
        pos_encoding_layer=jax_net_blocks.LearnableInversePositionalEncoding(
            use_pos_emb=True, session_max_len=L, n_factors=D
        ),
        transformer_layers=jax_ligr.LiGRLayers(
            n_blocks=BLOCKS, n_factors=D, n_heads=HEADS, dropout_rate=0.0, ff_activation=ff_activation,
            bias_in_ff=bias_in_ff,
        ),
        similarity_module=jax_similarity.DistanceSimilarityModule(distance="dot"),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=True,
        use_key_padding_mask=False,
    )
    rng = np.random.default_rng(23)
    x = _sessions(rng, 6)
    batch = {"x": jnp.asarray(x)}
    params = _random_like(jax_model.init(jax.random.PRNGKey(0), batch)["params"], rng)
    block = params["transformer_layers"]["block_1"]
    assert {"gating_linear_1", "gating_linear_2", "layer_norm_1", "layer_norm_2"} <= set(block)
    assert ("ff_linear_3" in block["feed_forward"]) == (ff_activation == "swiglu")
    assert ("bias" in block["feed_forward"]["ff_linear_1"]) == bias_in_ff

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
        transformer_layers=LiGRLayers(
            BLOCKS, D, HEADS, 0.0, ff_activation=ff_activation, bias_in_ff=bias_in_ff, device=cpu
        ),
        similarity_module=DistanceSimilarityModule("dot"),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=True,
        use_key_padding_mask=False,
    ).eval()
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        sessions = port.encode_sessions({"x": xt}, port.item_model.embed_catalog()).numpy()
        logits = port({"x": xt}).numpy()
    assert np.abs(jax_sessions).max() > 0.1
    np.testing.assert_allclose(sessions, jax_sessions, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits, jax_logits, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("ff_activation", ["swiglu", "gelu", "relu"])
def test_feed_forwards_match_jax(ff_activation: str, use_bias: bool) -> None:
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, D)).astype(np.float32)
    jax_ff = jax_net_blocks.init_feed_forward(D, 2, 0.0, ff_activation, use_bias)
    params = _random_like(jax_ff.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    expected = np.asarray(jax_ff.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    port_ff = init_feed_forward(D, 2, 0.0, ff_activation, use_bias, device=torch.device("cpu")).eval()
    assert isinstance(port_ff, SwigluFeedForward) == (ff_activation == "swiglu")
    port_ff.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = port_ff(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-6, rtol=0)


def test_unknown_ff_activation_raises_as_in_jax() -> None:
    with pytest.raises(ValueError, match="Unsupported ff_activation"):
        jax_net_blocks.init_feed_forward(D, 2, 0.0, "tanh")
    with pytest.raises(ValueError, match="Unsupported ff_activation"):
        init_feed_forward(D, 2, 0.0, "tanh")


# ------------------------------------------------------------------ eSASRec


def _jax_esasrec(**kwargs) -> JaxSASRecModel:
    return JaxSASRecModel(**CONFIG, dropout_rate=0.0, transformer_layers_type=jax_ligr.LiGRLayers,
                          loss="sampled_softmax", n_negatives=N_NEGATIVES, **kwargs)


def _port_esasrec(df: pd.DataFrame, start, **kwargs) -> SASRecModel:
    model = SASRecModel(**CONFIG, dropout_rate=0.0, transformer_layers_type=LiGRLayers, loss="sampled_softmax",
                        n_negatives=N_NEGATIVES, device="cpu", **kwargs)
    model._build_model_from_dataset(Dataset.construct(df))
    model.training_module.load_params(flax_params_to_state_dict(start))
    return model


def test_shared_negative_logits_match_jax(monkeypatch: pytest.MonkeyPatch) -> None:
    """One (B, K) negative set, injected on both sides in place of the counter
    hash draw: JAX ``_batch_logits``' shared route and the port's give the same
    (B, L, 1 + K) logits, and both leave the batch's host negatives aside."""
    df = _frame()
    kwargs = {"training_module_kwargs": {"negatives_sharing": "batch"}}
    jax_model = _jax_esasrec(**kwargs)
    jax_model._build_model_from_dataset(JaxDataset.construct(df))
    tm = jax_model.training_module
    first = jax_pad_batch(next(iter(jax_model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    assert first["negatives"].shape == (32, CONFIG["session_max_len"], N_NEGATIVES)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)
    n_items = jax_model.data_preparator.item_id_map.size
    negatives = np.random.default_rng(9).integers(1, n_items, size=(32, N_NEGATIVES))
    monkeypatch.setattr(jax_dropout, "hash_uniform_ints", lambda *args, **kw: jnp.asarray(negatives))
    expected = np.asarray(tm._batch_logits(tm.params, {k: jnp.asarray(v) for k, v in first.items()}, None,
                                           neg_rng=jax.random.PRNGKey(0)))
    assert expected.shape == (32, CONFIG["session_max_len"], 1 + N_NEGATIVES)

    model = _port_esasrec(df, start, **kwargs)
    port_tm = model.training_module
    assert port_tm._shares_negatives
    monkeypatch.setattr(port_tm_module, "hash_uniform_ints", lambda *args, **kw: torch.from_numpy(negatives))
    with torch.no_grad():
        got = port_tm._batch_logits(port_tm._device_batch(first), neg_words=(0, 0)).numpy()
    assert np.abs(expected).max() > 0.1
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=0)


def test_esasrec_one_epoch_matches_jax() -> None:
    """eSASRec with host-drawn negatives (the same batches and negatives on
    both sides): one epoch within 1e-4 of the JAX fit."""
    df = _frame()
    kwargs = {"training_module_kwargs": {"negatives_on_device": False}}
    jax_model = _jax_esasrec(**kwargs)
    jax_model._build_model_from_dataset(JaxDataset.construct(df))
    tm = jax_model.training_module
    first = jax_pad_batch(next(iter(jax_model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)
    tm.fit(jax_model.data_preparator.get_dataloader_train, jax_model.data_preparator.get_dataloader_val, 1)

    model = _port_esasrec(df, start, **kwargs)
    port_tm = model.training_module
    port_tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, 1)
    assert model.data_preparator.host_negatives and port_tm.global_step == tm.global_step > 1
    np.testing.assert_allclose(port_tm.train_loss_history, tm.train_loss_history, rtol=1e-4)
    expected = flax_params_to_state_dict(jax.tree.map(np.array, tm.params))
    for name, value in model.backbone.state_dict().items():
        # the key-projection biases: zero gradient in exact arithmetic, held to steps * lr
        tol = port_tm.global_step * 1e-3 if name.endswith("multi_head_attn.k_proj.bias") else 1e-4
        assert (value - expected[name]).abs().max().item() <= tol, name
