"""Mixed-precision training (``compute_dtype="bfloat16"``) in the port, held
against the JAX package's bf16 path on the CPU.

Every input is made from a seed with numpy and fed to both sides. The port
runs on CPU tensors, through the plain twins of the bf16 kernel forms
(kernels 1, 2, 4, 5, 6 and 7, and 15 and 16 of the public lse op). The twins
multiply bf16 values in f32, which is exact, so they differ from the card's
tensor-core products with f32 accumulation only in the order of the f32
sums; the JAX side runs its Pallas kernels in interpret mode, or its XLA
route where the JAX package takes that route on the CPU. A value rounded to
bf16 on both sides can still land one bf16 step apart (2^-8 relative) where
the two f32 sums straddle a rounding boundary, so the tolerances below are
stated relative to the largest entry and sit between that step and the
5e-2 of JAX's own bf16 tests (tests/ops/test_softmax_lse.py:64, :196).
"""

import typing as tp

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import BERT4RecModel as JaxBERT4RecModel
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu.models.nn.transformers import ligr as jax_ligr
from rectools_tpu.models.nn.transformers import losses as jax_losses
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu.ops import attention as jax_attention
from rectools_tpu.ops import layer_norm as jax_layer_norm
from rectools_tpu.ops import softmax_lse as jax_softmax_lse
from rectools_tpu.ops import stu_attention as jax_stu
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.metrics import HitRate
from rectools_tpu_torch.models import BERT4RecModel, HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn.transformers import LiGRLayers, flax_params_to_state_dict
from rectools_tpu_torch.ops import attention, layer_norm, softmax_lse, stu_attention

BF16 = torch.bfloat16
MASK_VALUE = -1e9
# Measured on the CPU at these shapes (largest over the cases), and the limit:
LSE_TOL = 1e-6  # lse, relative per row: 1.4e-7 (f32 sums of exact products on both sides)
GRAD_TOL = 1e-3  # kernel 7's ds and di, relative to the largest entry: 1.1e-4 and 2.8e-6 (a bf16 ds partial
# one step apart where the two f32 sums straddle a rounding boundary)
ATTN_TOL = 2e-3  # out, dq, dk, dv against the XLA route, relative to the largest entry: 5.4e-4
ATTN_PALLAS_TOL = 2e-2  # against the Pallas route (L >= 256), which keeps p in f32: 8.8e-3
LN_TOL = 2 ** -8  # LayerNorm y, dx, dγ, dβ, relative to the largest entry: 0 (the same f32 math)


def _t(x: np.ndarray, dtype=torch.float32, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).requires_grad_(grad)


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as f32 numpy (the values both sides start from)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(BF16).float().numpy()


def _rel(got, expected) -> float:
    got, expected = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    return float(np.abs(got - expected).max() / np.abs(expected).max())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ kernel 6


@pytest.mark.parametrize("m,n,d", [(200, 700, 32), (130, 4100, 64), (70, 2049, 128), (90, 2500, 16),
                                   (70, 2049, 256)])
def test_lse_twin_matches_jax_pallas(m: int, n: int, d: int) -> None:
    """Kernel 6's bf16 twin against JAX ``_lse_fwd_partials_kernel`` on bf16
    inputs in interpret mode, in the same 2,048-row item chunks."""
    rng = np.random.default_rng(m + n)
    s, items = _bf16_np(rng.normal(size=(m, d)) * 0.3), _bf16_np(rng.normal(size=(n, d)) * 0.3)
    expected = jax_softmax_lse.streaming_lse(
        jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16), None, 128, softmax_lse.LSE_CHUNK, True
    )
    got = softmax_lse.streaming_lse(_t(s, BF16), _t(items, BF16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=LSE_TOL)


# ------------------------------------------------------------------ kernel 7


def _ce_inputs(m: int, n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    s, items = _bf16_np(rng.normal(size=(m, d)) * 0.4), _bf16_np(rng.normal(size=(n, d)) * 0.4)
    y = rng.integers(1, n, size=m)
    y[: m // 7] = 0  # PAD targets: coeff 0, z = +inf
    w = rng.uniform(0.5, 1.5, size=m).astype(np.float32)
    logits = s.astype(np.float64) @ items.astype(np.float64).T
    lse = (logits.max(1) + np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1))).astype(np.float32)
    coeff = np.where(y == 0, 0.0, w / max(1, (y != 0).sum())).astype(np.float32)
    with np.errstate(divide="ignore"):
        z = (lse - np.log(coeff)).astype(np.float32)
    return s, items, z, y, coeff


@pytest.mark.parametrize("m,n,d", [(200, 700, 32), (130, 4100, 64), (70, 2049, 128), (130, 2100, 16),
                                   (70, 2049, 256)])
def test_ce_grads_twin_matches_jax_pallas(m: int, n: int, d: int) -> None:
    """Kernel 7's bf16 twin against JAX ``_ce_grads_z_fused_kernel`` on bf16
    inputs in interpret mode, in the port's 2,048-row chunks (so the bf16 ds
    partials round over the same items)."""
    s, items, z, y, coeff = _ce_inputs(m, n, d, m + n)
    exp_ds, exp_di = jax_softmax_lse.softmax_ce_grads_from_z(
        jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16), jnp.asarray(z), jnp.asarray(y),
        jnp.asarray(coeff), 128, softmax_lse.FUSED_BWD_CHUNK, True,
    )
    ds, di = softmax_lse.softmax_ce_grads_from_z(_t(s, BF16), _t(items, BF16), _t(z), torch.from_numpy(y),
                                                 _t(coeff))
    assert ds.dtype == di.dtype == torch.float32
    assert _rel(ds.numpy(), exp_ds) <= GRAD_TOL
    assert _rel(di.numpy(), exp_di) <= GRAD_TOL


def test_ds_partials_round_per_chunk() -> None:
    """With ``BF16_DS_PARTIALS`` the twin rounds each chunk's ds partial to
    bf16 before the f32 sum (JAX :456-473); with it off the partials stay f32
    and ds moves."""
    s, items, z, y, coeff = _ce_inputs(64, 4100, 32, 3)
    args = (_t(s, BF16), _t(items, BF16), _t(z), torch.from_numpy(y), _t(coeff))
    ds_bf16, di_bf16 = softmax_lse.softmax_ce_grads_from_z(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(softmax_lse, "BF16_DS_PARTIALS", False)
        ds_f32, di_f32 = softmax_lse.softmax_ce_grads_from_z(*args)
    assert torch.equal(di_bf16, di_f32)
    assert not torch.equal(ds_bf16, ds_f32)
    assert _rel(ds_bf16.numpy(), ds_f32.numpy()) <= 2 ** -8


# ------------------------------------------------------------------ route choice


def _jax_ce_split(m: int, n: int, d: int, dtype) -> bool:
    """The JAX package's choice between kernel 7 and the large-catalog route:
    the loss's tiling for the dtype (losses.py:119-127, 214-215), the fused
    kernel's partials at their dtype's itemsize (softmax_lse.py:720-723)."""
    if d <= 128:
        block_m, chunk_n = jax_losses._NARROW_D_TILING if dtype == jnp.bfloat16 else jax_losses._NARROW_D_TILING_F32
    elif dtype == jnp.bfloat16:
        block_m, chunk_n = jax_losses._WIDE_D_TILING
    else:
        block_m, chunk_n = jax_softmax_lse.DEFAULT_BLOCK_M, jax_softmax_lse.DEFAULT_CHUNK_N
    block_m = min(block_m, 384)
    chunk_n = min(chunk_n, max(1024, (4096 * 128 // max(d, 1)) // 1024 * 1024))
    itemsize = jnp.dtype(jax_softmax_lse._ds_partials_dtype(dtype)).itemsize
    return -(-n // chunk_n) * (-(-m // block_m) * block_m) * d * itemsize > jax_softmax_lse._FUSED_BWD_PARTIALS_BUDGET


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("m", [51_200, 102_400, 3_000])
def test_route_choice_counts_partials_at_their_itemsize(m: int, d: int) -> None:
    """At every (M, D) and both dtypes, and at catalogs around the JAX
    threshold, the port leaves kernel 7 exactly where JAX does; in bf16 that
    is twice as far out as in f32 (at 51,200 x 128: 163,840 against 81,920)."""
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        edge = next(n for n in (2 ** k for k in range(10, 40)) if _jax_ce_split(m, n, d, dtype))
        lo, hi = edge // 2, edge
        while hi - lo > 1:  # the first catalog JAX sends to the split route
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if not _jax_ce_split(m, mid, d, dtype) else (lo, mid)
        for n in (hi - 1, hi, hi + 4096):
            assert softmax_lse.ce_takes_split_route(m, n, d, tdtype) == _jax_ce_split(m, n, d, dtype), (dtype, n)
    assert not softmax_lse.ce_takes_split_route(51_200, 163_840, 128, BF16)
    assert softmax_lse.ce_takes_split_route(51_200, 163_841, 128, BF16)
    assert softmax_lse.ce_takes_split_route(51_200, 81_921, 128) and not softmax_lse.ce_takes_split_route(
        51_200, 81_920, 128)


@pytest.mark.parametrize("d", [16, 256])
def test_bf16_plan_takes_the_bf16_tile_at_16_and_256(monkeypatch, d: int) -> None:
    """At D = 16 and 256 the f32 kernels keep the SIMT tile (64-row session
    tiles, two fused blocks per multiprocessor, one split ds chunk); bf16
    towers take the bf16 kernels' own: one block per multiprocessor, up to 4
    ds chunks, 128-row session tiles at 16 and 64-row ones at 256. The plans
    (grid and partial bytes) follow the dtype, and the CPU twins take the
    order the card's plan gives (132 multiprocessors)."""
    m, n = 51_200, 15_872
    rows = 64 if d == 256 else 128
    assert softmax_lse._bwd_tile(d, BF16) == (rows, 1, 4) and softmax_lse._bwd_tile(d) == (64, 2, 1)
    m_tiles = -(-m // rows)
    tiles_per_group = -(-m_tiles // (132 // 8))  # 8 item chunks of 2,048 rows, one block per multiprocessor
    groups = -(-m_tiles // tiles_per_group)
    assert softmax_lse.fused_bwd_plan(m, n, d, 132, 2, BF16) == (tiles_per_group, groups,
                                                                 (8 * m * 2 + groups * n * 4) * d)
    assert softmax_lse.fused_bwd_plan(m, n, d, 132, 2) != softmax_lse.fused_bwd_plan(m, n, d, 132, 2, BF16)
    assert softmax_lse.split_bwd_plan(m, n, d, 132, dtype=BF16) == (4, 3_968)  # the f32 SIMT tile: one chunk
    assert softmax_lse.split_bwd_plan(m, n, d, 132) == (1, n)
    # the twins' order is the card's: record the partials flag each twin is asked for
    calls = []
    for name in ("softmax_ce_grads_from_z_bf16_reference", "softmax_grads_from_z_bf16_reference",
                 "streaming_lse_bwd_bf16_reference"):
        monkeypatch.setattr(softmax_lse, name, lambda *a, _n=name, partials=True, **k: calls.append(
            (_n, partials)) or (torch.zeros(1), torch.zeros(1)))
    s, items = torch.zeros((m, d), dtype=BF16), torch.zeros((n, d), dtype=BF16)
    z, y, c = torch.zeros(m), torch.zeros(m, dtype=torch.int64), torch.zeros(m)
    softmax_lse.softmax_ce_grads_from_z(s, items, z, y, c)
    softmax_lse.softmax_grads_from_z(s, items, z)
    softmax_lse.streaming_lse_bwd(s, items, None, z, z)
    card = [softmax_lse.fused_bwd_plan(m, n, d, 132, size, BF16)[2] <= softmax_lse.FUSED_BWD_PARTIALS_BUDGET
            for size in (2, 2, 4)]
    assert [partials for _, partials in calls] == card
    # at D = 256 kernel 9's 4-byte partials pass the budget (10 + 11), kernels 7 and 12 keep their one pass
    assert card == ([True, True, False] if d == 256 else [True, True, True])
    # the split twin walks the bf16 plan's chunks: 4 at the training shape, where the f32 SIMT tile takes one
    _, chunk_rows = softmax_lse.split_bwd_plan(m, n, d, 132, dtype=BF16)
    assert chunk_rows == 3_968 < n


def test_fused_plan_counts_bf16_partials_at_two_bytes() -> None:
    """Kernel 7's one pass at the KION shape: 8 chunks x 16 groups either way;
    the bf16 ds partials take half the f32 ones' bytes."""
    f32 = softmax_lse.fused_bwd_plan(51_200, 15_872, 128, 132)
    bf16 = softmax_lse.fused_bwd_plan(51_200, 15_872, 128, 132, 2)
    assert f32[:2] == bf16[:2] == (25, 16)
    assert f32[2] - bf16[2] == 8 * 51_200 * 128 * 2


# ------------------------------------------------------------------ attention


def _attention_case(b: int, h: int, l: int, dh: int, bias_kind: str, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (_bf16_np(rng.normal(size=(b, l, h, dh))) for _ in range(4))
    if bias_kind == "causal":
        bias = np.where(np.tril(np.ones((l, l), dtype=bool)), 0.0, MASK_VALUE).astype(np.float32)[None, None]
    elif bias_kind == "key_padding":  # BERT4Rec: padded keys masked, the diagonal kept
        pad = np.zeros((b, l), dtype=bool)
        pad[:, : l // 3] = True
        masked = np.where(pad[:, None, None, :], MASK_VALUE, 0.0)
        bias = np.where(np.eye(l, dtype=bool)[None, None], 0.0, np.broadcast_to(masked, (b, 1, l, l)))
        bias = bias.astype(np.float32)
    else:
        bias = None
    return q, k, v, dout, bias


def _jax_attention(q, k, v, dout, bias, rate, seed, use_fused=False, interpret=False):
    l = q.shape[1]
    scale = 1.0 / q.shape[-1] ** 0.5
    jbias = None if bias is None else jnp.asarray(bias)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jseed = jnp.asarray([seed], jnp.int32)

    def fwd(q_, k_, v_):
        if use_fused:
            qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (q_, k_, v_))
            full = jnp.zeros((1, 1, l, l), jnp.float32) if jbias is None else jbias
            out = jax_attention.fused_attention(qt, kt, vt, full, jseed, scale, rate, 128, interpret, False)
            return out.transpose(0, 2, 1, 3)
        return jax_attention.dot_product_attention(q_, k_, v_, jbias, scale, use_fused=False, dropout_rate=rate,
                                                   dropout_seed=jseed if rate else None)

    out, vjp = jax.vjp(fwd, *args)
    return (out, *vjp(jnp.asarray(dout, jnp.bfloat16)))


def _port_attention(q, k, v, dout, bias, rate, seed):
    scale = 1.0 / q.shape[-1] ** 0.5
    tq, tk, tv = (_t(x, BF16, grad=True) for x in (q, k, v))
    out = attention.dot_product_attention(tq, tk, tv, None if bias is None else _t(bias), scale,
                                          dropout_rate=rate, dropout_seed=seed if rate else None)
    out.backward(_t(dout, BF16))
    return out, tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize(
    "b,h,l,dh,bias_kind,rate",
    [(3, 2, 20, 16, "causal", 0.2), (2, 4, 100, 32, "causal", 0.2), (2, 2, 70, 64, "key_padding", 0.0),
     (2, 2, 33, 32, "none", 0.1), (2, 2, 100, 32, "key_padding", 0.2), (2, 4, 100, 8, "causal", 0.2),
     (2, 4, 70, 8, "key_padding", 0.0)],
)
def test_attention_twins_match_jax_xla_route(b, h, l, dh, bias_kind, rate) -> None:
    """Kernels 2 and 5's bf16 twins against the JAX route below L = 256
    (``xla_attention``), out and dq, dk, dv, with the same dropout bits; at
    heads of 8 too (SASRec's and BERT4Rec's n_factors 32 with 4 heads)."""
    q, k, v, dout, bias = _attention_case(b, h, l, dh, bias_kind, l + dh)
    expected = _jax_attention(q, k, v, dout, bias, rate, 11)
    got = _port_attention(q, k, v, dout, bias, rate, 11)
    for name, g, e in zip(("out", "dq", "dk", "dv"), got, expected):
        assert g.dtype == BF16, name
        assert _rel(_np(g), _np(e)) <= ATTN_TOL, name


def test_attention_twins_against_jax_pallas_route_at_256() -> None:
    """At L = 256 JAX takes its Pallas kernels (interpret mode here), which keep
    p and the scores in f32 and sum dv in bf16 a query block at a time; the
    port keeps the XLA route's rounding points at every L (ROADMAP §3). The
    two agree within ``ATTN_PALLAS_TOL``."""
    q, k, v, dout, bias = _attention_case(1, 2, 256, 32, "causal", 5)
    expected = _jax_attention(q, k, v, dout, bias, 0.2, 3, use_fused=True, interpret=True)
    got = _port_attention(q, k, v, dout, bias, 0.2, 3)
    for name, g, e in zip(("out", "dq", "dk", "dv"), got, expected):
        assert _rel(_np(g), _np(e)) <= ATTN_PALLAS_TOL, name


def test_fully_masked_row_sums_v_in_bf16() -> None:
    """A row whose every key is masked gets p = 1 on each key (the XLA route's
    value, ROADMAP §3), in bf16 as in f32."""
    q, k, v, dout, _ = _attention_case(1, 1, 8, 16, "none", 2)
    bias = np.zeros((1, 1, 8, 8), np.float32)
    bias[..., 3, :] = MASK_VALUE
    out, _ = attention.attention_fwd(*(_t(x, BF16).transpose(1, 2) for x in (q, k, v)), _t(bias), 0.25)
    expected = _t(v).sum(dim=1)[0].to(BF16)
    assert torch.equal(out[0, :, 3], expected)


# ------------------------------------------------------------------ LayerNorm


def test_layer_norm_bf16_matches_jax() -> None:
    """LayerNorm on bf16 activations and bf16 γ, β (the cast parameters):
    the bf16 forms' twins (the f32 twins on the widened values), y and dx in
    bf16, dγ and dβ at γ's dtype, against JAX ``fused_layer_norm`` in
    interpret mode (tests/ops/test_layer_norm.py:61) and its VJP."""
    rng = np.random.default_rng(4)
    x, dy = _bf16_np(rng.normal(size=(128, 64)) * 2 + 0.5), _bf16_np(rng.normal(size=(128, 64)))
    gamma, beta = _bf16_np(rng.normal(size=64)), _bf16_np(rng.normal(size=64))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, gamma, beta)]
    y_exp, vjp = jax.vjp(lambda *a: jax_layer_norm.fused_layer_norm(*a, 1e-6, 128, True), *jargs)
    dx_exp, dg_exp, db_exp = vjp(jnp.asarray(dy, jnp.bfloat16))
    tx, tg, tb = (_t(a, BF16, grad=True) for a in (x, gamma, beta))
    y = layer_norm.layer_norm(tx, tg, tb, 1e-6)
    y.backward(_t(dy, BF16))
    assert y.dtype == tx.grad.dtype == tg.grad.dtype == tb.grad.dtype == BF16
    for name, g, e in (("y", y, y_exp), ("dx", tx.grad, dx_exp), ("dgamma", tg.grad, dg_exp),
                       ("dbeta", tb.grad, db_exp)):
        assert _rel(_np(g), _np(e)) <= LN_TOL, name


# ------------------------------------------------------------------ the bf16 item table


def test_embedding_gather_sums_its_gradient_as_jax() -> None:
    """The bf16 catalog table's gather (backbone.py:86) and its other reads:
    the gather's scatter-add sums duplicates in bf16, one rounding an added
    row, in index order, and adds the direct read's cotangent after it, as
    XLA does; on one thread the port's gradient equals JAX's bit for bit (1,000
    ones sum to 256 on both)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(0)
        n, d, m = 50, 8, 4000
        table = rng.normal(size=(n, d)).astype(np.float32)
        idx = rng.integers(0, n, size=m)
        idx[:1000] = 7
        a = _bf16_np(rng.normal(size=(m, d)))
        a[:1000] = 1.0
        b = _bf16_np(rng.normal(size=(n, d)))

        def jax_loss(t32):
            cat = t32.astype(jnp.bfloat16).at[0].set(0.0)
            gathered = (cat[idx] * jnp.asarray(a, jnp.bfloat16)).astype(jnp.float32)
            return jnp.sum(gathered) + jnp.sum((cat * jnp.asarray(b, jnp.bfloat16)).astype(jnp.float32))

        expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
        t = _t(table, grad=True)
        tb = t.to(BF16)
        cat = torch.cat([tb.new_zeros((1, d)), tb[1:]])
        loss = (cat[torch.from_numpy(idx)] * _t(a, BF16)).float().sum() + (cat * _t(b, BF16)).float().sum()
        loss.backward()
        np.testing.assert_array_equal(t.grad.numpy(), expected)
        assert t.grad[7].max().item() < 1000  # the 1,000 ones, summed in bf16
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------------------------ fits


def _leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


FIT_LR = 1e-3
FIT_CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5, lr=FIT_LR,
                  get_val_mask_func=_leave_last_out)
FIT_KWARGS = {"fused_softmax_chunk": 64, "compute_dtype": "bfloat16"}
N_NEGATIVES = 7
# The 3-step fits against JAX's bf16 fits (measured on the CPU, and the limit): the epoch's train loss
# 7.3e-6 to 1.7e-5 relative (4.2e-5 at heads of 8; limit 1e-4), its validation loss 1.5e-5 to 2.3e-4
# (limit 1e-3; one forward of bf16 layers whose roundings differ in places, such as a linear layer's bias
# added in its product's epilogue). The parameters: Adam moves an entry by up to lr a step whatever its
# gradient's size, so an entry whose bf16 gradient is rounding noise on both sides (the key-projection
# biases, and rare items' rows) can part by up to 2 x steps x lr = 6e-3 (5.7e-3 measured): that bounds
# every entry; the mean over all entries is the real check, 2.1e-5 to 3.8e-5 (limit 1e-4; the port's own
# bf16 fit sits 1.8e-5 to 3.6e-5 from its f32 fit).
FIT_LOSS_RTOL = 1e-4
FIT_VAL_LOSS_RTOL = 1e-3
FIT_PARAM_TOL = 2 * 3 * FIT_LR
FIT_PARAM_MEAN_TOL = 1e-4


def _fit_frame() -> pd.DataFrame:
    """96 users (3 batches of 32: one epoch is 3 steps), ~300 items."""
    rng = np.random.default_rng(17)
    n = 1500
    return pd.DataFrame(
        {
            Columns.User: np.arange(n) % 96,
            Columns.Item: rng.zipf(1.2, n) % 300,
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
        }
    )


def _families():
    return {
        "sasrec": (JaxSASRecModel, SASRecModel, {}, {}),
        "bert4rec": (JaxBERT4RecModel, BERT4RecModel, {}, {}),
        "esasrec": (JaxSASRecModel, SASRecModel,
                    dict(transformer_layers_type=jax_ligr.LiGRLayers, loss="sampled_softmax",
                         n_negatives=N_NEGATIVES),
                    dict(transformer_layers_type=LiGRLayers, loss="sampled_softmax", n_negatives=N_NEGATIVES)),
    }


# heads of 8: the transformer config's default 4 heads at n_factors 32
HEADS_OF_8 = dict(n_factors=32, n_heads=4)


def _jax_fit(family: str, df: pd.DataFrame, width: tp.Optional[dict] = None):
    jax_cls, _, jax_kwargs, _ = _families()[family]
    extra = {"negatives_on_device": False} if family == "esasrec" else {}
    model = jax_cls(**{**FIT_CONFIG, **(width or {})}, dropout_rate=0.0,
                    training_module_kwargs={**FIT_KWARGS, **extra}, **jax_kwargs)
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
    tm.init_params(first)
    start = jax.tree.map(np.array, tm.params)
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    return start, tm


def _port_fit(family: str, df: pd.DataFrame, start, compute_dtype: str = "bfloat16", width: tp.Optional[dict] = None):
    _, port_cls, _, port_kwargs = _families()[family]
    extra = {"negatives_on_device": False} if family == "esasrec" else {}
    model = port_cls(**{**FIT_CONFIG, **(width or {})}, dropout_rate=0.0, device="cpu",
                     training_module_kwargs={**FIT_KWARGS, "compute_dtype": compute_dtype, **extra}, **port_kwargs)
    model._build_model_from_dataset(Dataset.construct(df))
    tm = model.training_module
    tm.load_params(flax_params_to_state_dict(start))
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, 1)
    return model


@pytest.fixture(scope="module")
def fits():
    df = _fit_frame()
    out = {}
    for family in _families():
        start, jax_tm = _jax_fit(family, df)
        out[family] = (df, start, jax_tm)
    return out


@pytest.mark.parametrize("family", ["sasrec", "bert4rec", "esasrec"])
def test_three_step_bf16_fit_matches_jax(fits, family: str) -> None:
    """3 Adam steps with bf16 compute from the same converted start: the
    losses and the f32 master parameters follow JAX's bf16 fit. (JAX on the
    CPU differentiates its XLA loss scan, the port runs kernel 7's bf16
    rounding points, so the two part by bf16 roundings of the gradients.)"""
    df, start, jax_tm = fits[family]
    _check_against_jax_fit(_port_fit(family, df, start), jax_tm, family)


def test_three_step_bf16_fit_at_heads_of_8_matches_jax() -> None:
    """The same for SASRec at n_factors 32 with 4 heads (heads of 8: the bf16
    forms of kernels 2 and 5 at head dim 8, here their twins)."""
    df = _fit_frame()
    start, jax_tm = _jax_fit("sasrec", df, HEADS_OF_8)
    model = _port_fit("sasrec", df, start, width=HEADS_OF_8)
    assert model.n_factors // model.n_heads == 8
    _check_against_jax_fit(model, jax_tm, "sasrec")


def _check_against_jax_fit(model, jax_tm, family: str) -> None:
    tm = model.training_module
    assert tm.resolved_compute_dtype == jax_tm.resolved_compute_dtype == "bfloat16"
    assert tm.global_step == jax_tm.global_step == 3
    if family != "esasrec":
        assert tm._use_fused_softmax
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=FIT_LOSS_RTOL)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=FIT_VAL_LOSS_RTOL)
    expected = flax_params_to_state_dict(jax.tree.map(np.array, jax_tm.params))
    diffs = []
    for name, value in model.backbone.state_dict().items():
        assert value.dtype == torch.float32, name  # the master weights stay f32
        err = (value - expected[name]).abs()
        diffs.append(err.reshape(-1))
        assert err.max().item() <= FIT_PARAM_TOL, name
    assert torch.cat(diffs).mean().item() <= FIT_PARAM_MEAN_TOL


@pytest.mark.parametrize("family", ["sasrec", "bert4rec", "esasrec"])
def test_bf16_fit_tracks_the_f32_fit(fits, family: str) -> None:
    """The bf16 fit's losses within 2e-2 of the port's f32 fit from the same
    start, as tests/ops/test_softmax_lse.py:206-220 holds JAX's bf16 loss."""
    df, start, _ = fits[family]
    bf16 = _port_fit(family, df, start).training_module
    f32 = _port_fit(family, df, start, "float32").training_module
    np.testing.assert_allclose(bf16.train_loss_history, f32.train_loss_history, rtol=2e-2)
    assert bf16.train_loss_history != f32.train_loss_history


def test_bf16_step_launches_the_bf16_forms_only(fits, monkeypatch) -> None:
    """A bf16 train step reaches the bf16 forms (here their twins) and no f32
    attention or loss twin; LayerNorm takes its bf16 twins, each of which runs
    the f32 twin on the widened values and nothing else."""
    calls = []
    for module, names in ((attention, ("attention_reference", "attention_bwd_reference", "attention_bf16_reference",
                                       "attention_bwd_bf16_reference")),
                          (softmax_lse, ("streaming_lse_partials_reference", "streaming_lse_bf16_reference",
                                         "softmax_ce_grads_from_z_reference",
                                         "softmax_ce_grads_from_z_bf16_reference")),
                          (layer_norm, ("layer_norm_reference", "layer_norm_bwd_reference",
                                        "layer_norm_bf16_reference", "layer_norm_bwd_bf16_reference"))):
        for name in names:
            twin = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, _n=name, _t=twin, **k: calls.append(_n) or _t(*a, **k))
    df, start, _ = fits["sasrec"]
    model = SASRecModel(**FIT_CONFIG, dropout_rate=0.2, device="cpu", training_module_kwargs=FIT_KWARGS)
    model._build_model_from_dataset(Dataset.construct(df))
    tm = model.training_module
    tm.load_params(flax_params_to_state_dict(start))
    batch = next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0))))
    tm._train_step(tm._device_batch(batch))
    n = FIT_CONFIG["n_blocks"]
    assert calls.count("attention_bf16_reference") == calls.count("attention_bwd_bf16_reference") == n
    assert calls.count("streaming_lse_bf16_reference") == calls.count("softmax_ce_grads_from_z_bf16_reference") == 1
    assert calls.count("layer_norm_bf16_reference") == calls.count("layer_norm_bwd_bf16_reference") == 2 * n + 1
    assert calls.count("layer_norm_reference") == calls.count("layer_norm_bwd_reference") == 2 * n + 1
    assert "attention_reference" not in calls and "softmax_ce_grads_from_z_reference" not in calls
    # the bf16 lse twin is kernel 6's f32 twin on the widened values: once, from it
    assert calls.count("streaming_lse_partials_reference") == 1
    assert all(p.dtype == torch.float32 for p in tm.backbone.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in tm.optimizer.state.values())


def test_bf16_remat_recasts_to_the_plain_fit(fits) -> None:
    """With remat the backward recomputes the towers, the bf16 casts included
    (they sit inside the rematerialized function): on one thread the fit
    repeats the plain bf16 fit's bits."""
    df, start, _ = fits["sasrec"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for remat in (False, True):
            model = SASRecModel(**FIT_CONFIG, dropout_rate=0.2, device="cpu",
                                training_module_kwargs={**FIT_KWARGS, "remat": remat})
            model._build_model_from_dataset(Dataset.construct(df))
            tm = model.training_module
            tm.load_params(flax_params_to_state_dict(start))
            tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, 1)
            runs[remat] = (tm.train_loss_history, model.backbone.state_dict())
    finally:
        torch.set_num_threads(threads)
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(runs[True][1][name], value) for name, value in runs[False][1].items())


# ------------------------------------------------------------------ test_bf16_drift counterparts


def _cyclic_dataset(n_users: int = 120, n_items: int = 12, session_len: int = 9):
    rng = np.random.default_rng(5)
    rows, test_rows = [], []
    for u in range(n_users):
        start = int(rng.integers(0, n_items))
        items = [(start + t) % n_items for t in range(session_len + 1)]
        for t, i in enumerate(items[:-1]):
            rows.append((u, i, 1.0, pd.Timestamp("2021-01-01") + pd.Timedelta(days=t)))
        test_rows.append((u, items[-1]))
    df = pd.DataFrame(rows, columns=Columns.Interactions)
    test = pd.DataFrame(test_rows, columns=[Columns.User, Columns.Item])
    return Dataset.construct(df), test


def _drift_model(compute_dtype: str) -> SASRecModel:
    return SASRecModel(
        n_blocks=1, n_heads=1, n_factors=32, session_max_len=10, epochs=25, batch_size=64, lr=0.01,
        dropout_rate=0.0, seed=0, device="cpu", training_module_kwargs={"compute_dtype": compute_dtype},
    )


def test_auto_resolves_to_float32_in_the_port() -> None:
    """``"auto"`` stays ``"auto"`` in the config and resolves to float32 in the
    port on every device (JAX: bf16 on a TPU only; ROADMAP §3); an explicit
    ``"bfloat16"`` resolves to itself."""
    dataset, _ = _cyclic_dataset(n_users=10, session_len=4)
    model = _drift_model("auto")
    model.epochs = 1
    model.fit(dataset)
    assert model.training_module.compute_dtype == "auto"
    assert model.training_module.resolved_compute_dtype == "float32"
    explicit = _drift_model("bfloat16")
    explicit.epochs = 1
    explicit.fit(dataset)
    assert explicit.training_module.resolved_compute_dtype == "bfloat16"


def test_rejects_unknown_dtype() -> None:
    dataset, _ = _cyclic_dataset(n_users=10, session_len=4)
    with pytest.raises(ValueError, match="compute_dtype"):
        _drift_model("float16").fit(dataset)


def test_bf16_quality_tracks_f32() -> None:
    """The cyclic next-item task of test_bf16_drift.py: hit@1 above 0.9 for
    both dtypes and within 0.05 of each other."""
    dataset, test = _cyclic_dataset()
    users = test[Columns.User].unique()
    hits = {}
    for dtype in ("float32", "bfloat16"):
        model = _drift_model(dtype)
        model.fit(dataset)
        reco = model.recommend(users, dataset, k=1, filter_viewed=False)
        hits[dtype] = HitRate(k=1).calc(reco, test)
    assert hits["float32"] > 0.9, hits
    assert hits["bfloat16"] > 0.9, hits
    assert abs(hits["bfloat16"] - hits["float32"]) <= 0.05, hits


# ------------------------------------------------------------------ refused routes


def _bf16_towers(m: int, n: int, d: int):
    rng = np.random.default_rng(0)
    return _t(rng.normal(size=(m, d)), BF16), _t(rng.normal(size=(n, d)), BF16)


def test_refused_routes_raise_naming_the_roadmap(monkeypatch) -> None:
    """No route of the port refuses bf16 any more: the routes that raised
    before they had bf16 forms now run. The bounded-shift (kernel 16) and
    running-max (kernel 15) forwards, also at the widths 16 and 256, against
    JAX's kernels in interpret mode on the same bf16 inputs; the loss routes
    at D = 16 and 256, against their twins and against JAX in interpret mode
    where a route has a JAX kernel; attention and STU attention at head dim
    8, against JAX's XLA route and ``_stu_reference``."""
    s, items = _bf16_towers(300, 5000, 32)
    z, coeff, y = torch.zeros(300), torch.full((300,), 1e-3), torch.ones(300, dtype=torch.int64)
    narrow = _bf16_towers(8, 3000, 16)
    wide = _bf16_towers(8, 3000, 256)

    def jax_lse(towers, bounded_shift=False):
        jt = [jnp.asarray(_np(t), jnp.bfloat16) for t in towers]
        return np.asarray(jax_softmax_lse.streaming_lse(*jt, None, 128, softmax_lse.LSE_CHUNK, True, bounded_shift))

    scaled = tuple((t.float() * 0.2).to(BF16) for t in (s, items))  # inside kernel 16's contract at d = 32
    for towers in (scaled, narrow):  # kernel 16 runs, against JAX
        got = softmax_lse.streaming_lse(*towers, bounded_shift=True)
        np.testing.assert_allclose(got.numpy(), jax_lse(towers, True), rtol=LSE_TOL)
    # what raised at head dim 8 runs: kernel 2's bf16 form (its twin here) against JAX's XLA route ...
    q, k, v, _, _ = _attention_case(1, 2, 6, 8, "none", 8)
    out, _ = attention.attention_fwd(*(_t(x, BF16).transpose(1, 2) for x in (q, k, v)), None, 0.3)
    expected = jax_attention.dot_product_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), None, 0.3,
                                                   use_fused=False)
    assert out.dtype == BF16 and _rel(_np(out.transpose(1, 2)), _np(expected)) <= ATTN_TOL
    # ... and kernel 17's against _stu_reference (no time or position bias: the bias is 0)
    l, rng = 6, np.random.default_rng(8)
    q, k, v = (_bf16_np(0.5 * rng.normal(size=(1, 2, l, 8))) for _ in range(3))
    timeline, allowed = np.ones((1, l), np.float32), np.tril(np.ones((l, l), np.float32))
    out = stu_attention.stu_fwd(*(_t(x, BF16) for x in (q, k, v)), torch.zeros((1, l, l)), _t(allowed[None]),
                                _t(timeline))
    expected = jax_stu._stu_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                      jnp.zeros((1, l + 1), jnp.int32), jnp.asarray(timeline, jnp.bfloat16), None,
                                      None, jnp.asarray(allowed, jnp.bfloat16), 128, False, False)
    assert out.dtype == BF16 and _rel(_np(out), _np(expected)) <= ATTN_TOL
    with monkeypatch.context() as mp:  # kernel 15 runs, against JAX, at the new widths too
        mp.setattr(softmax_lse, "USE_PARTIALS_FWD", False)
        mp.setattr(jax_softmax_lse, "_USE_PARTIALS_FWD", False)
        for towers in ((s, items), wide):
            np.testing.assert_allclose(softmax_lse.streaming_lse(*towers).numpy(), jax_lse(towers), rtol=LSE_TOL)
    # what raised at D = 16 and 256 runs, through the bf16 twins on the CPU
    bias = torch.zeros(3000)
    bias[-2:] = softmax_lse.NEG_BIG
    lse_wide = softmax_lse.streaming_lse(*wide, bias)
    assert torch.equal(lse_wide, softmax_lse.streaming_lse_bias_bf16_reference(*wide, bias))
    assert torch.equal(softmax_lse.streaming_lse(*wide), softmax_lse.streaming_lse_bf16_reference(*wide))
    lse_narrow = softmax_lse.streaming_lse(*narrow)
    dlse = torch.linspace(-1.0, 1.0, 8)
    got = softmax_lse.streaming_lse_bwd(*narrow, None, lse_narrow, dlse)
    want = softmax_lse.streaming_lse_bwd_bf16_reference(*narrow, torch.zeros(3000), lse_narrow, dlse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    zn = lse_narrow - torch.log(coeff[:8])
    got = softmax_lse.softmax_grads_from_z(*narrow, zn)
    assert all(torch.equal(g, w) for g, w in zip(got, softmax_lse.softmax_grads_from_z_bf16_reference(*narrow, zn)))
    # kernel 7 at d = 16 in its three routes: the one pass, its two launches, the large-catalog route (budget 0),
    # each against JAX's kernel 7 or large-catalog route in interpret mode on the same inputs
    jargs = [jnp.asarray(_np(t), jnp.bfloat16) for t in narrow] + [jnp.asarray(t.numpy()) for t in (zn, y[:8],
                                                                                          coeff[:8])]
    for budget in (softmax_lse.FUSED_BWD_PARTIALS_BUDGET, 100_000, 0):
        with monkeypatch.context() as mp:
            mp.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", budget)
            mp.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", budget)
            ds, di = softmax_lse.softmax_ce_grads_from_z(*narrow, zn, y[:8], coeff[:8])
            exp_ds, exp_di = jax_softmax_lse.softmax_ce_grads_from_z(*jargs, 128, softmax_lse.FUSED_BWD_CHUNK, True)
        assert _rel(ds.numpy(), exp_ds) <= GRAD_TOL and _rel(di.numpy(), exp_di) <= GRAD_TOL, budget


def test_refused_models_raise_naming_the_roadmap() -> None:
    """The model fits that raised before their bf16 forms existed now run. HSTU
    at head dim 8 (n_factors 16, 2 heads: kernels 17-19 at ad = lh = 8) fits in
    bf16 and tracks its f32 fit from the same seed. A mesh fit at width 16
    fits on the twins of the mesh loss's kernels 8-11 and tracks the bf16 fit
    without a mesh (kernels 6 and 7) from the same seed."""
    dataset, _ = _cyclic_dataset(n_users=10, session_len=4)
    hstu_losses = {}
    for dtype in ("bfloat16", "float32"):
        hstu = HSTUModel(n_blocks=1, n_heads=2, n_factors=16, session_max_len=6, epochs=1, batch_size=8,
                         device="cpu", training_module_kwargs={"compute_dtype": dtype}, relative_time_attention=False)
        hstu.fit(dataset)
        assert hstu.training_module.resolved_compute_dtype == dtype
        hstu_losses[dtype] = hstu.training_module.train_loss_history
    assert np.isfinite(hstu_losses["bfloat16"]).all() and hstu_losses["bfloat16"] != hstu_losses["float32"]
    np.testing.assert_allclose(hstu_losses["bfloat16"], hstu_losses["float32"], rtol=2e-2)
    losses = {}
    for name, extra in (("mesh", {"mesh_shape": (1, 1)}), ("plain", {})):
        model = SASRecModel(n_blocks=1, n_heads=1, n_factors=16, session_max_len=6, epochs=1, batch_size=8,
                            device="cpu", training_module_kwargs={"compute_dtype": "bfloat16",
                                                                  "fused_softmax_chunk": 8, **extra})
        model.fit(dataset)  # 12 items: the fused (mesh) loss
        assert model.is_fitted and model.training_module.resolved_compute_dtype == "bfloat16"
        losses[name] = model.training_module.train_loss_history
    assert np.isfinite(losses["mesh"]).all()
    np.testing.assert_allclose(losses["mesh"], losses["plain"], rtol=1e-4)


# ------------------------------------------------------------------ mixed dtypes


def test_wrappers_refuse_mixed_dtypes() -> None:
    """Each kernel wrapper takes one operand dtype: a bf16 / f32 pair raises,
    on the CPU as on the card."""
    s, items = _bf16_towers(16, 100, 32)
    z, coeff, y = torch.zeros(16), torch.ones(16), torch.ones(16, dtype=torch.int64)
    q = _t(np.ones((1, 2, 4, 16)), BF16)
    x = _t(np.ones((4, 32)), BF16)
    mixed = {
        "lse": lambda: softmax_lse.streaming_lse(s, items.float()),
        "ce_grads": lambda: softmax_lse.softmax_ce_grads_from_z(s.float(), items, z, y, coeff),
        "attention_fwd": lambda: attention.attention_fwd(q, q.float(), q, None, 0.3),
        "attention_bwd": lambda: attention.attention_bwd(q, q, q, None, torch.zeros(1, 2, 4), torch.zeros(1, 2, 4),
                                                         q.float(), 0.3),
        "layer_norm_fwd": lambda: layer_norm.layer_norm_fwd(x, torch.ones(32, dtype=BF16), torch.zeros(32)),
        "layer_norm_bwd": lambda: layer_norm.layer_norm_bwd(x, torch.ones(32), x.float()),
    }
    for what, call in mixed.items():
        with pytest.raises(TypeError, match="mixed operand dtypes"):
            call()

