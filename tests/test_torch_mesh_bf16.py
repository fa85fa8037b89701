"""The mesh loss on bf16 towers (``compute_dtype="bfloat16"`` with
``mesh_shape``): the twins of kernels 8-11's bf16 forms held against the JAX
package's kernels on bf16 inputs in interpret mode, on the CPU.

Every input is made from a seed with numpy, rounded to bf16, and fed to both
sides. The twins multiply bf16 values in f32, which is exact, and round at
the JAX kernels' points (rectools_tpu/ops/softmax_lse.py): kernel 8 adds the
f32 bias to the f32 logits; kernel 9 rounds pw = exp(logit + bias - lse) *
dlse to bf16 once for both products and keeps f32 ds partials; kernel 10
rounds the same pw; kernel 11 rounds p and s * dlse. Both sides then differ
only in the order of f32 sums (JAX walks 64-row chunks here, the twins the
card's 2,048-row chunks), and a gradient rounded to bf16 on both sides can
land one bf16 step (2^-8 relative) apart where two f32 sums straddle a
rounding boundary. The tolerances below stand beside the largest value
measured over the cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.models.nn.transformers import losses as jax_losses
from rectools_tpu.ops import softmax_lse as jax_softmax_lse
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn.transformers import losses
from rectools_tpu_torch.ops import _native, softmax_lse

BF16 = torch.bfloat16
# Measured on the CPU over the cases below, and the limit:
LSE_TOL = 1e-6  # kernel 8's lse, relative per row: 1.7e-7 (f32 sums of exact products in another order)
GRAD_TOL = 2 ** -8  # ds and di in bf16, relative to the largest entry: 0 to 2.0e-3 (one bf16 step of an entry
# whose f32 sum straddles a rounding boundary)
# (name: (M, N, D, invalid item rows)): ragged M and N over one, two and three 2,048-row chunks, rows biased
# -1e30 in the middle and at the end (a shard's zero padding), and a shard whose every row is invalid; D from 16
# to the models' default 256
CASES = {
    "d32_tail": (50, 301, 32, "tail"),
    "d64_two_chunks": (40, 2111, 64, "scattered"),
    "d128_three_chunks": (33, 4500, 128, "tail"),
    "d128_valid": (70, 2100, 128, "none"),
    "d32_all_invalid": (20, 40, 32, "all"),
    "d256_tail": (40, 2101, 256, "tail"),
    "d16_two_chunks": (60, 4200, 16, "scattered"),
}


def _bf16_np(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(BF16).float().numpy()


def _case(name: str):
    m, n, d, invalid = CASES[name]
    rng = np.random.default_rng(m + n + d)
    s = _bf16_np(rng.normal(size=(m, d)) * 0.3)
    items = _bf16_np(rng.normal(size=(n, d)) * 0.3)
    bias = np.zeros(n, np.float32)
    if invalid == "tail":
        bias[-3:] = -1e30
    elif invalid == "scattered":
        bias[n // 3 :: 97] = -1e30
        bias[-1] = -1e30
    elif invalid == "all":
        bias[:] = -1e30
    items[bias < 0] = 0.0  # a shard's padding rows are zeros
    dlse = rng.normal(size=m).astype(np.float32)  # mixed sign
    dlse[::7] = 0.0
    return s, items, bias, dlse


def _bf16(x: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(x).to(BF16).requires_grad_(grad)


def _rel(got, expected) -> float:
    got, expected = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    return float(np.abs(got - expected).max() / max(np.abs(expected).max(), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ kernel 8


@pytest.mark.parametrize("name", sorted(CASES))
def test_biased_lse_twin_matches_jax(name: str) -> None:
    """Kernel 8's bf16 twin (and ``streaming_lse`` with a bias on bf16
    towers, which takes it) against JAX ``_lse_fwd_kernel`` on bf16 inputs in
    interpret mode; a zero bias gives kernel 6's bf16 twin bit for bit, and a
    wholly invalid table ``-1e30 + log(N)``, never NaN."""
    s, items, bias, _ = _case(name)
    expected = np.asarray(jax_softmax_lse.streaming_lse(
        jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16), jnp.asarray(bias), 16, 64, True))
    got = softmax_lse.streaming_lse(_bf16(s), _bf16(items), torch.from_numpy(bias))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), expected, rtol=LSE_TOL, atol=0)
    twin = softmax_lse.streaming_lse_bias_bf16_reference(_bf16(s), _bf16(items), torch.from_numpy(bias))
    assert torch.equal(got, twin)
    if CASES[name][3] == "none":
        assert torch.equal(got, softmax_lse.streaming_lse_bf16_reference(_bf16(s), _bf16(items)))


# ------------------------------------------------------------------ kernels 9, 10 and 11


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_vjp_twins_match_jax(monkeypatch, name: str, route: str) -> None:
    """The VJP on bf16 towers (kernel 9's twin, or 10 + 11's with the partials
    budget forced to 0 on both sides) against ``jax.grad`` of the JAX kernels
    on bf16 inputs in interpret mode: ds and di come back in bf16, within one
    bf16 step of JAX's, and an invalid row's di is exactly 0 (a wholly invalid
    table's lse is -1e30 itself, so its rows weigh exp(0); the sharded merge
    gives such a shard a zero cotangent)."""
    s, items, bias, dlse = _case(name)
    if route == "split":
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
        monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)

    def value(s_, i_):
        return jnp.sum(jax_softmax_lse.streaming_lse(s_, i_, jnp.asarray(bias), 16, 64, True) * dlse)

    eds, edi = jax.grad(value, argnums=(0, 1))(jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16))
    ts, ti = _bf16(s, True), _bf16(items, True)
    lse = softmax_lse.streaming_lse(ts, ti, torch.from_numpy(bias))
    (lse * torch.from_numpy(dlse)).sum().backward()
    assert ts.grad.dtype == ti.grad.dtype == BF16 and eds.dtype == edi.dtype == jnp.bfloat16
    assert _rel(_np(ts.grad), _np(eds)) <= GRAD_TOL
    assert _rel(_np(ti.grad), _np(edi)) <= GRAD_TOL
    if CASES[name][3] in ("tail", "scattered"):  # an invalid row beside valid ones: exactly 0
        assert not _np(ti.grad)[bias < 0].any()


def test_split_di_rounds_at_kernel_11s_points() -> None:
    """Kernel 11 rounds p and s * dlse to bf16 (rectools_tpu/ops/softmax_lse.py
    :275-287), kernel 9 rounds their product pw (:258): the split twin's di is
    pᵀ (s · dlse) of those bf16 values to f32 rounding, and not the fused
    twin's arithmetic in another order."""
    s, items, bias, dlse = _case("d64_two_chunks")
    ts, ti, tb, tg = _bf16(s), _bf16(items), torch.from_numpy(bias), torch.from_numpy(dlse)
    lse = softmax_lse.streaming_lse_fwd(ts, ti, tb)
    _, di_split = softmax_lse.streaming_lse_bwd_bf16_reference(ts, ti, tb, lse, tg, partials=False)
    _, di_fused = softmax_lse.streaming_lse_bwd_bf16_reference(ts, ti, tb, lse, tg, partials=True)
    s32, i32 = ts.float(), ti.float()
    p = torch.exp((s32 @ i32.T + tb[None, :]) - lse[:, None]).to(BF16).double()
    ws = (s32 * tg[:, None]).to(BF16).double()
    pw = (torch.exp((s32 @ i32.T + tb[None, :]) - lse[:, None]) * tg[:, None]).to(BF16).double()
    scale = (p.T @ ws).abs().max().item()
    assert (di_split.double() - p.T @ ws).abs().max().item() <= 1e-6 * scale
    assert (di_fused.double() - pw.T @ s32.double()).abs().max().item() <= 1e-6 * scale
    assert (di_split - di_fused).abs().max().item() > 1e-5 * scale  # the two roundings part


@pytest.mark.parametrize("m,n,d", [(51200, 15872, 128), (25600, 7936, 128), (4096, 40000, 64)])
def test_bf16_lse_backward_counts_its_partials_at_four_bytes(monkeypatch, m: int, n: int, d: int) -> None:
    """Kernel 9's route test counts 4-byte ds partials whatever the towers'
    dtype (rectools_tpu/ops/softmax_lse.py:487); only kernel 7 reads
    ``BF16_DS_PARTIALS``. With the budget between the 2-byte and the 4-byte
    plan, bf16 towers take kernels 10 + 11 (the twin is asked for the split
    order), and at the default budget the fused kernel."""
    two = softmax_lse.fused_bwd_plan(m, n, d, 132, ds_itemsize=2)[2]
    four = softmax_lse.fused_bwd_plan(m, n, d, 132)[2]
    assert two < four
    orders = []

    def twin(*args, partials):
        orders.append(partials)
        return torch.zeros(1), torch.zeros(1)

    monkeypatch.setattr(softmax_lse, "streaming_lse_bwd_bf16_reference", twin)
    s, items = torch.zeros((m, d), dtype=BF16), torch.zeros((n, d), dtype=BF16)
    lse, dlse = torch.zeros(m), torch.zeros(m)
    softmax_lse.streaming_lse_bwd(s, items, None, lse, dlse)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", (two + four) // 2)
    softmax_lse.streaming_lse_bwd(s, items, None, lse, dlse)
    assert orders == [four <= 512 * 1024 * 1024, False]


def test_lse_backward_keeps_float32_bits() -> None:
    """f32 towers keep the f32 twins' route and bits (the bf16 lift changes
    nothing for them)."""
    s, items, bias, dlse = _case("d128_three_chunks")
    ts, ti, tb, tg = (torch.from_numpy(x) for x in (s, items, bias, dlse))
    lse = softmax_lse.streaming_lse_fwd(ts, ti, tb)
    assert torch.equal(lse, softmax_lse.streaming_lse_bias_reference(ts, ti, tb))
    got = softmax_lse.streaming_lse_bwd(ts, ti, tb, lse, tg)
    expected = softmax_lse.streaming_lse_bwd_reference(ts, ti, tb, lse, tg)
    assert all(g.dtype == torch.float32 and torch.equal(g, e) for g, e in zip(got, expected))


# ------------------------------------------------------------------ the label term


def test_ce_from_lse_label_term_rounds_as_jax() -> None:
    """``_ce_from_lse`` on bf16 towers: the label logit an f32 sum of bf16
    products, its gradients computed in f32 and rounded to bf16 once per
    entry (the session side) and scattered in bf16 (the item side), as JAX's
    ``einsum(..., preferred_element_type=f32)`` and gather transpose do: the
    loss and both gradients bit for bit. The lse is held fixed (no gradient)
    so only the label term moves; the labels are distinct, so no duplicate is
    summed in an order either side picks."""
    rng = np.random.default_rng(3)
    b, l, d, n = 4, 6, 32, 50
    s = _bf16_np(rng.normal(size=(b, l, d)))
    items = _bf16_np(rng.normal(size=(n, d)))
    y = rng.permutation(np.arange(1, n))[: b * l].reshape(b, l)
    y[0, :2] = 0  # PAD targets contribute nothing
    w = np.ones((b, l), np.float32)
    lse = rng.normal(size=(b, l)).astype(np.float32) + 10.0

    def jax_loss(s_, i_):
        return jax_losses._ce_from_lse(s_, i_, jnp.asarray(y), jnp.asarray(w), jnp.asarray(lse))

    expected = jax_loss(jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16))
    eds, edi = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16))
    ts, ti = _bf16(s, True), _bf16(items, True)
    got = losses._ce_from_lse(ts, ti, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(lse))
    got.backward()
    assert got.item() == float(expected)
    assert ts.grad.dtype == ti.grad.dtype == BF16
    np.testing.assert_array_equal(_np(ts.grad), _np(eds))
    np.testing.assert_array_equal(_np(ti.grad), _np(edi))


# ------------------------------------------------------------------ the mesh route in one process


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


CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5,
              dropout_rate=0.2, device="cpu")
KWARGS = {"fused_softmax_chunk": 64, "compute_dtype": "bfloat16"}


def _count_twins(monkeypatch) -> list:
    calls = []
    for name in ("streaming_lse_bf16_reference", "streaming_lse_bias_bf16_reference",
                 "softmax_ce_grads_from_z_bf16_reference", "streaming_lse_bwd_bf16_reference",
                 "streaming_lse_bias_reference", "streaming_lse_bwd_reference", "softmax_ce_grads_from_z_reference"):
        twin = getattr(softmax_lse, name)
        monkeypatch.setattr(softmax_lse, name, lambda *a, _n=name, _t=twin, **k: calls.append(
            (_n, k.get("partials"))) or _t(*a, **k))
    return calls


@pytest.mark.parametrize("model_cls", [SASRecModel, HSTUModel])
def test_mesh_of_one_bf16_step_runs_kernels_8_and_9(monkeypatch, model_cls) -> None:
    """A bf16 train step at ``mesh_shape=(1, 1)``: the loss takes kernel 8's
    and kernel 9's bf16 twins once each and nothing of kernels 6 and 7 or of
    the f32 loss twins; with the partials budget forced to 0, 10 + 11's."""
    extra = {"relative_time_attention": False} if model_cls is HSTUModel else {}
    model = model_cls(**CONFIG, training_module_kwargs={**KWARGS, "mesh_shape": (1, 1)}, **extra)
    dataset = Dataset.construct(_frame())
    model._build_model_from_dataset(dataset)
    tm = model.training_module
    tm.init_params()
    batch = next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0))))
    calls = _count_twins(monkeypatch)
    before = dict(_native.LAUNCHES)
    losses_seen = [float(tm._train_step(tm._device_batch(tm._local_batch(batch))))]
    assert calls == [("streaming_lse_bias_bf16_reference", None), ("streaming_lse_bwd_bf16_reference", True)]
    calls.clear()
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    losses_seen.append(float(tm._train_step(tm._device_batch(tm._local_batch(batch)))))
    assert calls == [("streaming_lse_bias_bf16_reference", None), ("streaming_lse_bwd_bf16_reference", False)]
    assert np.isfinite(losses_seen).all() and losses_seen[1] < losses_seen[0]
    assert dict(_native.LAUNCHES) == before  # the CPU runs twins: no kernel launched
    assert all(p.dtype == torch.float32 for p in tm.backbone.parameters())


def test_mesh_of_one_bf16_fit_tracks_the_bf16_fit() -> None:
    """``mesh_shape=(1, 1)`` with bf16 compute (kernels 8 and 9's twins)
    against the bf16 fit without a mesh (6 and 7's) from the same seed: the
    same loss to bf16 rounding (kernel 7 stores bf16 ds partials, kernel 9
    f32 ones) and the f32 fit's within 2e-2."""
    dataset = Dataset.construct(_frame())
    fits = {}
    for name, kwargs in (("mesh", {**KWARGS, "mesh_shape": (1, 1)}), ("plain", KWARGS),
                         ("f32", {"fused_softmax_chunk": 64})):
        model = SASRecModel(**CONFIG, training_module_kwargs=kwargs)
        model.fit(dataset)
        fits[name] = model.training_module.train_loss_history
    np.testing.assert_allclose(fits["mesh"], fits["plain"], rtol=1e-4)
    np.testing.assert_allclose(fits["mesh"], fits["f32"], rtol=2e-2)
