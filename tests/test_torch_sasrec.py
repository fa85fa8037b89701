"""The port's SASRec modules, held against the JAX package on the CPU.

Parameters are drawn from a seed with numpy in the JAX package's flax layout,
go into the JAX modules as they are and into the port through
``flax_params_to_state_dict``; the same sessions go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu import Columns as JaxColumns
from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn import item_net as jax_item_net
from rectools_tpu.models.nn.transformers import backbone as jax_backbone
from rectools_tpu.models.nn.transformers import net_blocks as jax_net_blocks
from rectools_tpu.models.nn.transformers import sasrec as jax_sasrec
from rectools_tpu.models.nn.transformers import similarity as jax_similarity
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models.nn import item_net
from rectools_tpu_torch.models.nn.transformers import (
    LearnableInversePositionalEncoding,
    SASRecDataPreparator,
    SASRecTransformerLayers,
    TransformerBackbone,
    flax_params_to_state_dict,
)
from rectools_tpu_torch.models.nn.transformers.similarity import DistanceSimilarityModule

D, HEADS, BLOCKS, L, N_ITEMS = 32, 2, 2, 12, 50


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


@pytest.mark.parametrize(
    "key_padding,distance", [(False, "dot"), (True, "dot"), (False, "cosine")]
)
def test_backbone_matches_jax(key_padding: bool, distance: str) -> None:
    jax_model = jax_backbone.TransformerBackbone(
        item_model=jax_item_net.SumOfEmbeddingsConstructor(
            n_items=N_ITEMS,
            item_net_blocks=(jax_item_net.IdEmbeddingsItemNet(n_items=N_ITEMS, n_factors=D, dropout_rate=0.0),),
        ),
        pos_encoding_layer=jax_net_blocks.LearnableInversePositionalEncoding(
            use_pos_emb=True, session_max_len=L, n_factors=D
        ),
        transformer_layers=jax_sasrec.SASRecTransformerLayers(
            n_blocks=BLOCKS, n_factors=D, n_heads=HEADS, dropout_rate=0.0
        ),
        similarity_module=jax_similarity.DistanceSimilarityModule(distance=distance),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=True,
        use_key_padding_mask=key_padding,
    )
    rng = np.random.default_rng(17)
    x = _sessions(rng, 6)
    batch = {"x": jnp.asarray(x)}
    params = _random_like(jax_model.init(jax.random.PRNGKey(0), batch)["params"], rng)

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
        transformer_layers=SASRecTransformerLayers(BLOCKS, D, HEADS, 0.0, device=cpu),
        similarity_module=DistanceSimilarityModule(distance),
        n_heads=HEADS,
        dropout_rate=0.0,
        use_causal_attn=True,
        use_key_padding_mask=key_padding,
    ).eval()
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        sessions = port.encode_sessions({"x": xt}, port.item_model.embed_catalog()).numpy()
        logits = port({"x": xt}).numpy()
    np.testing.assert_allclose(sessions, jax_sessions, atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits, jax_logits, atol=1e-4, rtol=0)


def _frame(rng: np.random.Generator) -> pd.DataFrame:
    n = 300
    return pd.DataFrame(
        {
            Columns.User: rng.integers(0, 30, n),
            Columns.Item: rng.integers(0, 40, n),
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10000, n), unit="m"),
        }
    )


def test_item_net_with_cat_features_matches_jax() -> None:
    rng = np.random.default_rng(3)
    df = _frame(rng)
    items = np.unique(df[Columns.Item])
    features = pd.DataFrame(
        {
            "id": np.concatenate([items, items[::3]]),
            "feature": ["genre"] * len(items) + ["studio"] * len(items[::3]),
            "value": np.concatenate([rng.integers(0, 5, len(items)), rng.integers(0, 3, len(items[::3]))]),
        }
    )
    kwargs = dict(item_features_df=features, cat_item_features=["genre", "studio"])
    jax_prep = jax_sasrec.SASRecDataPreparator(session_max_len=L, batch_size=8)
    jax_prep.process_dataset_train(JaxDataset.construct(df, **kwargs))
    port_prep = SASRecDataPreparator(session_max_len=L, batch_size=8)
    port_prep.process_dataset_train(Dataset.construct(df, **kwargs))

    jax_net = jax_item_net.SumOfEmbeddingsConstructor.from_dataset(
        jax_prep.train_dataset, D, 0.0, (jax_item_net.IdEmbeddingsItemNet, jax_item_net.CatFeaturesItemNet)
    )
    params = _random_like(jax_net.init(jax.random.PRNGKey(0), method="embed_catalog")["params"], rng)
    expected = np.asarray(jax_net.apply({"params": jax.tree.map(jnp.asarray, params)}, method="embed_catalog"))

    port_net = item_net.SumOfEmbeddingsConstructor.from_dataset(
        port_prep.train_dataset, D, 0.0, (item_net.IdEmbeddingsItemNet, item_net.CatFeaturesItemNet),
        device=torch.device("cpu"),
    )
    assert len(port_net.item_net_blocks) == 2
    # converted trees may carry a nonzero PAD row: the port zeroes it at use
    assert np.abs(params["item_net_blocks_0"]["ids_emb"][0]).sum() > 0
    port_net.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = port_net.embed_catalog().numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=1e-6)
    assert not got[0].any()  # PAD: zeroed id row, no feature values


def test_data_preparator_matches_jax() -> None:
    rng = np.random.default_rng(5)
    df = _frame(rng)
    jax_prep = jax_sasrec.SASRecDataPreparator(session_max_len=5, batch_size=8, train_min_user_interactions=3)
    port_prep = SASRecDataPreparator(session_max_len=5, batch_size=8, train_min_user_interactions=3)
    jax_ds, port_ds = JaxDataset.construct(df), Dataset.construct(df)
    jax_prep.process_dataset_train(jax_ds)
    port_prep.process_dataset_train(port_ds)
    np.testing.assert_array_equal(
        port_prep.item_id_map.external_ids.astype(str), jax_prep.item_id_map.external_ids.astype(str)
    )
    np.testing.assert_array_equal(
        port_prep.get_known_items_sorted_internal_ids(), jax_prep.get_known_items_sorted_internal_ids()
    )

    users = np.unique(df[JaxColumns.User])[::2]
    jax_u2i = jax_prep.transform_dataset_u2i(jax_ds, users)
    port_u2i = port_prep.transform_dataset_u2i(port_ds, users)
    jax_batches = list(jax_prep.get_dataloader_recommend(jax_u2i, 4))
    port_batches = list(port_prep.get_dataloader_recommend(port_u2i, 4))
    assert len(port_batches) == len(jax_batches) > 1
    for got, expected in zip(port_batches, jax_batches):
        np.testing.assert_array_equal(got["x"], expected["x"])
    np.testing.assert_array_equal(
        port_u2i.user_id_map.external_ids, jax_u2i.user_id_map.external_ids
    )
    jax_i2i = jax_prep.transform_dataset_i2i(jax_ds)
    port_i2i = port_prep.transform_dataset_i2i(port_ds)
    pd.testing.assert_frame_equal(port_i2i.interactions.df, jax_i2i.interactions.df)
