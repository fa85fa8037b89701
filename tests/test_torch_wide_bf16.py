"""bf16 training at the models' default width d = 256 and at d = 16: the bf16
loss forms' tile at those widths, and 3-step bf16 fits of SASRec and HSTU held
against the JAX package's bf16 fits on the CPU.

The JAX side runs its bf16 training on the CPU (its XLA loss scan); the port
runs its CPU twins of the bf16 kernel forms, which multiply bf16 values in f32
and round where the JAX kernels round, in the order the card's plan gives
(``_bwd_tile(d, torch.bfloat16)``). Every start is converted from JAX's
initial parameters, so the two fits differ only by bf16 roundings of sums
taken in another order.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import HSTUModel as JaxHSTUModel
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn.transformers import flax_params_to_state_dict
from rectools_tpu_torch.ops import softmax_lse

REPO = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
# the 3-step fits against JAX's bf16 fits (tests/test_torch_bf16.py's limits), and measured on the CPU over the three
# fits: train loss 6.9e-7 to 2.8e-5, validation loss 1.5e-5 to 2.6e-5
FIT_LOSS_RTOL, FIT_VAL_LOSS_RTOL = 1e-4, 1e-3


def test_bf16_tile_matches_the_cuda_source() -> None:
    """The bf16 forms' tile in ops/softmax_lse.py is the one
    csrc/softmax_lse_bf16.cu is built for: one rule picks 64-row session
    tiles above D = 128 and 128 rows below, for the one pass's grid and the
    split ds grid alike; the item tile is 64 rows; the entries dispatch every
    width of ``SUPPORTED_D``."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "softmax_lse_bf16.cu").read_text()
    assert "constexpr int grad_bm(int D) { return D > 128 ? 64 : 128; }" in src
    assert int(re.search(r"^constexpr int kBN = (\d+);", src, re.M).group(1)) == softmax_lse.TILE
    assert src.count("(M + grad_bm(D) - 1) / grad_bm(D)") == 2  # launch_ce's groups, launch_ds's grid
    widths = {int(w) for w in re.findall(r"case (\d+): return fn\(std::integral_constant<int, \d+>\{\}\);", src)}
    assert widths == set(softmax_lse.SUPPORTED_D)
    assert "switch (D)" not in src.replace("int by_width(int D, Fn fn) {\n  switch (D)", "")
    for d in softmax_lse.SUPPORTED_D:
        assert softmax_lse._bwd_tile(d, BF16) == (64 if d > 128 else 128, 1, 4)


def _leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


FIT_CONFIG = dict(n_blocks=1, session_max_len=20, batch_size=32, epochs=1, seed=5, lr=1e-3, dropout_rate=0.0,
                  get_val_mask_func=_leave_last_out)
FIT_KWARGS = {"fused_softmax_chunk": 64, "compute_dtype": "bfloat16"}
# (JAX class, port class, width): the models' default width with 4 heads (heads of 64), and d = 16 with one head
FITS = {"sasrec_d256": (JaxSASRecModel, SASRecModel, dict(n_factors=256, n_heads=4)),
        "hstu_d256": (JaxHSTUModel, HSTUModel, dict(n_factors=256, n_heads=4)),
        "sasrec_d16": (JaxSASRecModel, SASRecModel, dict(n_factors=16, n_heads=1))}


def _fit_frame() -> pd.DataFrame:
    """96 users (3 batches of 32: one epoch is 3 steps), ~300 items, timestamps within 10^6 s."""
    rng = np.random.default_rng(17)
    n = 1500
    return pd.DataFrame(
        {
            Columns.User: np.arange(n) % 96,
            Columns.Item: rng.zipf(1.2, n) % 300,
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
        }
    ).astype({Columns.Datetime: "datetime64[ns]"})  # the unit the JAX package's unix seconds assume


@pytest.fixture(scope="module", params=sorted(FITS))
def jax_fit(request):
    """JAX's bf16 fit of one model on the CPU and its start."""
    jax_cls, _, width = FITS[request.param]
    df = _fit_frame()
    model = jax_cls(**FIT_CONFIG, **width, training_module_kwargs=FIT_KWARGS)
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    return request.param, df, start, tm


def test_three_step_bf16_fit_matches_jax(jax_fit, monkeypatch) -> None:
    """3 Adam steps with bf16 compute from JAX's start at d = 256 (SASRec,
    HSTU; 4 heads) and d = 16 (SASRec): every step's loss takes the bf16
    twins of kernels 6 and 7's one pass and no f32 twin, and the train and
    validation losses follow JAX's bf16 fit."""
    name, df, start, jax_tm = jax_fit
    calls = []
    for twin in ("streaming_lse_bf16_reference", "softmax_ce_grads_from_z_bf16_reference",
                 "softmax_ce_grads_from_z_reference", "streaming_lse_bwd_bf16_reference"):
        fn = getattr(softmax_lse, twin)
        monkeypatch.setattr(softmax_lse, twin, lambda *a, _n=twin, _f=fn, **k: calls.append(
            (_n, k.get("partials"))) or _f(*a, **k))
    _, port_cls, width = FITS[name]
    model = port_cls(**FIT_CONFIG, **width, device="cpu", training_module_kwargs=FIT_KWARGS)
    model._build_model_from_dataset(Dataset.construct(df))
    tm = model.training_module
    tm.load_params(flax_params_to_state_dict(start))
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, 1)
    assert tm.resolved_compute_dtype == jax_tm.resolved_compute_dtype == "bfloat16"
    assert tm.global_step == jax_tm.global_step == 3 and tm._use_fused_softmax
    train_calls = [c for c in calls if c[0] == "softmax_ce_grads_from_z_bf16_reference"]
    assert train_calls == [("softmax_ce_grads_from_z_bf16_reference", True)] * 3
    assert not any(c[0] in ("softmax_ce_grads_from_z_reference", "streaming_lse_bwd_bf16_reference") for c in calls)
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=FIT_LOSS_RTOL)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=FIT_VAL_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tm.backbone.parameters())
