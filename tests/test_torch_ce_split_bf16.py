"""bf16 training on large catalogs: the twins of kernel 7's two launches and of
kernels 12-14 in bf16, and the large-catalog CE route on bf16 towers, held
against the JAX package's bf16 functions on the CPU.

Every input is made from a seed with numpy, rounded to bf16, and fed to both
sides. The JAX side runs its Pallas kernels in interpret mode, with
``_FUSED_BWD_PARTIALS_BUDGET`` forced to 0 where the split kernels 13 + 14 are
meant; the port runs on CPU tensors, through the twins, which multiply the
bf16 values in f32 (exact) and round where the JAX kernels round
(rectools_tpu/ops/softmax_lse.py): kernel 12 rounds P = exp(logit - z) once
for both products and stores its ds partials per 2,048-row chunk in bf16
(:611-640, :818-820); kernel 13 sums ds in f32 over every chunk (:757-771);
kernel 14 rounds P once (:774-790); the large-catalog route subtracts the
label term in f32 (:748-754). JAX has no form of kernel 7's two launches: the
port's twin of them keeps the one pass's rounding points, so the two twins
differ only in the order of f32 sums. A value rounded to bf16 on both sides
can still land one bf16 step apart where two f32 sums straddle a rounding
boundary, so the tolerances are relative to the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import HSTUModel as JaxHSTUModel
from rectools_tpu.models.nn.transformers import SASRecModel as JaxSASRecModel
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu.ops import softmax_lse as jax_softmax_lse
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.models.nn.transformers import flax_params_to_state_dict, losses
from rectools_tpu_torch.ops import softmax_lse

BF16 = torch.bfloat16
# Measured on the CPU over the cases below (largest), and the limit:
GRAD_TOL = 1e-3  # ds and di against JAX, relative to the largest entry (tests/test_torch_bf16.py's limit): kernel 12
# 8.5e-4, kernels 13 + 14 1.3e-4 (a P one bf16 step apart where the two sides' f32 logits straddle a rounding
# boundary), the large-catalog route 3.0e-6, kernel 7's two launches against JAX's one pass 2.4e-4
ORDER_TOL = 1e-5  # kernel 7's two-launch twin against its one-pass twin: the same roundings, f32 sums in another
# order: 0 (a few bf16 partials sum exactly in f32 in any order at these sizes)
# the 3-step fits against JAX's bf16 fits (tests/test_torch_bf16.py's limits): train loss 1.6e-6 to 2.1e-5,
# validation loss 3.0e-5 to 1.1e-4
FIT_LOSS_RTOL, FIT_VAL_LOSS_RTOL = 1e-4, 1e-3
# (M, N, D): odd catalogs with a tail in one, three and ten 2,048-row chunks; the last spans several steps of each
# chunk of kernel 7's split plan; the models' default width 256 (64-row session tiles on the card) and 16
CASES = [(200, 701, 32), (130, 4100, 64), (70, 2049, 128), (40, 20011, 32), (70, 2049, 256), (130, 4100, 16)]


def _bf16_np(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(BF16).float().numpy()


def _rel(got, expected) -> float:
    got, expected = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    return float(np.abs(got - expected).max() / np.abs(expected).max())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(m: int, n: int, d: int):
    """bf16 towers, labels with PAD rows (coeff 0, z = +inf) and a label shared
    by many rows, and z = lse - log(coeff)."""
    rng = np.random.default_rng(m + n + d)
    s, items = _bf16_np(rng.normal(size=(m, d)) * 0.4), _bf16_np(rng.normal(size=(n, d)) * 0.4)
    y = rng.integers(1, n, size=m)
    y[m // 3 : m // 3 + m // 5] = n - 1  # duplicate labels, on the catalog's tail
    y[: m // 7] = 0
    w = rng.uniform(0.5, 1.5, size=m).astype(np.float32)
    logits = s.astype(np.float64) @ items.astype(np.float64).T
    lse = (logits.max(1) + np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1))).astype(np.float32)
    coeff = np.where(y == 0, 0.0, w / max(1, (y != 0).sum())).astype(np.float32)
    with np.errstate(divide="ignore"):
        z = (lse - np.log(coeff)).astype(np.float32)
    return s, items, z, y, coeff


def _port(s, items, z, y=None, coeff=None):
    args = (torch.from_numpy(s).to(BF16), torch.from_numpy(items).to(BF16), torch.from_numpy(z))
    if y is None:
        return softmax_lse.softmax_grads_from_z(*args)
    return softmax_lse.softmax_ce_grads_from_z(*args, torch.from_numpy(y), torch.from_numpy(coeff))


def _jax(s, items, z, y=None, coeff=None):
    args = (jnp.asarray(s, jnp.bfloat16), jnp.asarray(items, jnp.bfloat16), jnp.asarray(z))
    tiles = (128, softmax_lse.FUSED_BWD_CHUNK, True)
    if y is None:
        return jax_softmax_lse.softmax_grads_from_z(*args, *tiles)
    return jax_softmax_lse.softmax_ce_grads_from_z(*args, jnp.asarray(y), jnp.asarray(coeff), *tiles)


def _record_twins(monkeypatch) -> list:
    """Wrap the bf16 gradient twins: each call appends (twin, partials)."""
    calls = []
    for name in ("softmax_grads_from_z_bf16_reference", "softmax_ce_grads_from_z_bf16_reference"):
        twin = getattr(softmax_lse, name)

        def wrapped(*a, _n=name, _t=twin, partials=True, **k):
            calls.append((_n, partials))
            return _t(*a, partials=partials, **k)

        monkeypatch.setattr(softmax_lse, name, wrapped)
    return calls


# ------------------------------------------------------------------ kernel 12


@pytest.mark.parametrize("m,n,d", CASES)
def test_grads_from_z_runs_kernel_12_and_matches_jax(monkeypatch, m: int, n: int, d: int) -> None:
    """The softmax gradients from z on bf16 towers run (kernel 12's twin: the
    plan's bf16 partials fit the budget) and match JAX ``_grads_z_fused_kernel``
    in interpret mode in the port's 2,048-row chunks (so the bf16 ds partials
    round over the same items); ds and di come back in f32 and an ignored
    row's ds is exactly 0."""
    calls = _record_twins(monkeypatch)
    s, items, z, _, coeff = _inputs(m, n, d)
    ds, di = _port(s, items, z)
    assert calls == [("softmax_grads_from_z_bf16_reference", True)]
    exp_ds, exp_di = _jax(s, items, z)
    assert ds.dtype == di.dtype == torch.float32
    assert _rel(ds, exp_ds) <= GRAD_TOL and _rel(di, exp_di) <= GRAD_TOL
    assert not ds[torch.from_numpy(coeff == 0)].any()


@pytest.mark.parametrize("m,n,d", [(70, 2049, 128), (70, 2049, 256), (130, 4100, 16)])
def test_kernel_12_twin_is_kernel_7s_without_the_label_term(m: int, n: int, d: int) -> None:
    """Kernel 12 runs on kernel 7's bf16 engine with the label term dropped,
    so its twin is kernel 7's one-pass twin with coeff = 0, bit for bit (and
    JAX defines kernel 7 as kernel 12 with the label correction fused in,
    rectools_tpu/ops/softmax_lse.py:643); both held against JAX's kernel 12
    in interpret mode."""
    s, items, z, y, _ = _inputs(m, n, d)
    args = (torch.from_numpy(s).to(BF16), torch.from_numpy(items).to(BF16), torch.from_numpy(z))
    twin = softmax_lse.softmax_grads_from_z_bf16_reference(*args, partials=True)
    no_label = softmax_lse.softmax_ce_grads_from_z_bf16_reference(
        *args, torch.from_numpy(y), torch.zeros((m,), dtype=torch.float32), partials=True)
    assert all(torch.equal(a, b) for a, b in zip(twin, no_label))
    exp_ds, exp_di = _jax(s, items, z)
    assert _rel(twin[0], exp_ds) <= GRAD_TOL and _rel(twin[1], exp_di) <= GRAD_TOL


def test_kernel_12_rounds_its_ds_partials() -> None:
    """Under ``BF16_DS_PARTIALS`` kernel 12's twin stores each chunk's ds
    partial in bf16 (JAX :818-820); with it off they stay f32, ds moves by
    less than a bf16 step and di does not move."""
    s, items, z, _, _ = _inputs(64, 4100, 32)
    ds_bf16, di_bf16 = _port(s, items, z)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(softmax_lse, "BF16_DS_PARTIALS", False)
        ds_f32, di_f32 = _port(s, items, z)
    assert torch.equal(di_bf16, di_f32) and not torch.equal(ds_bf16, ds_f32)
    assert _rel(ds_bf16, ds_f32) <= 2 ** -8


# ------------------------------------------------------------------ kernels 13 + 14


@pytest.mark.parametrize("m,n,d", CASES)
def test_grads_from_z_runs_kernels_13_14_and_matches_jax(monkeypatch, m: int, n: int, d: int) -> None:
    """With the partials budget forced to 0 on both sides, kernels 13 + 14's
    twin (ds summed in f32 over every chunk, P rounded once for di) against
    JAX ``_ds_z_kernel`` and ``_di_z_kernel`` in interpret mode."""
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)
    calls = _record_twins(monkeypatch)
    s, items, z, _, coeff = _inputs(m, n, d)
    ds, di = _port(s, items, z)
    assert calls == [("softmax_grads_from_z_bf16_reference", False)]
    exp_ds, exp_di = _jax(s, items, z)
    assert _rel(ds, exp_ds) <= GRAD_TOL and _rel(di, exp_di) <= GRAD_TOL
    assert not ds[torch.from_numpy(coeff == 0)].any()


def test_kernel_13_sums_ds_in_f32() -> None:
    """Kernel 13's twin rounds nothing between chunks: its ds is the exact
    f32 product of the rounded P, and kernel 12's differs from it by its bf16
    partials."""
    s, items, z, _, _ = _inputs(40, 4100, 32)
    args = (torch.from_numpy(s).to(BF16), torch.from_numpy(items).to(BF16), torch.from_numpy(z))
    split = softmax_lse.softmax_grads_from_z_bf16_reference(*args, partials=False)
    fused = softmax_lse.softmax_grads_from_z_bf16_reference(*args, partials=True)
    p = torch.exp(args[0].float() @ args[1].float().T - args[2][:, None]).to(BF16).double()
    exact = p @ torch.from_numpy(items).double()
    assert _rel(split[0], exact) <= 1e-6
    assert _rel(fused[0], exact) > 1e-5


# ------------------------------------------------------------------ the large-catalog CE route


@pytest.mark.parametrize("m,n,d", CASES)
def test_large_catalog_route_runs_and_matches_jax(monkeypatch, m: int, n: int, d: int) -> None:
    """Above JAX's bf16 split threshold (forced here: the budget 0 on both
    sides) the CE gradients on bf16 towers take kernels 13 + 14 and the
    label term in f32, and match JAX's very-large-catalog route in interpret
    mode, duplicate labels and coeff = 0 rows included."""
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)
    assert softmax_lse.ce_takes_split_route(m, n, d, BF16)
    calls = _record_twins(monkeypatch)
    s, items, z, y, coeff = _inputs(m, n, d)
    ds, di = _port(s, items, z, y, coeff)
    assert calls == [("softmax_grads_from_z_bf16_reference", False)]
    exp_ds, exp_di = _jax(s, items, z, y, coeff)
    assert ds.dtype == di.dtype == torch.float32
    assert _rel(ds, exp_ds) <= GRAD_TOL and _rel(di, exp_di) <= GRAD_TOL


def test_large_catalog_label_sum_is_f32(monkeypatch) -> None:
    """The route's segment sum adds in f32 on bf16 towers (JAX :753): 1,000
    rows of ones labelled 5 with coeff 1 take 1,000 off di's row 5 (a bf16
    sum would stop at 256), as JAX does."""
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)
    m, n, d = 1000, 300, 32
    rng = np.random.default_rng(5)
    s = np.ones((m, d), np.float32)
    items = _bf16_np(rng.normal(size=(n, d)) * 0.1)
    y, coeff = np.full(m, 5), np.ones(m, np.float32)
    z = np.full(m, 1e4, np.float32)  # P vanishes: di is the label term alone
    ds, di = _port(s, items, z, y, coeff)
    np.testing.assert_array_equal(di[5].numpy(), np.full(d, -1000.0, np.float32))
    np.testing.assert_array_equal(ds.numpy(), -np.broadcast_to(items[5], (m, d)))
    exp_ds, exp_di = _jax(s, items, z, y, coeff)
    np.testing.assert_array_equal(di.numpy(), _np(exp_di))
    np.testing.assert_array_equal(ds.numpy(), _np(exp_ds))


# ------------------------------------------------------------------ kernel 7's two launches


def _two_launch_budget(m: int, n: int, d: int) -> int:
    """A budget under the bf16 plan's one-pass partials and over the JAX rule's
    bytes: the CE gradients stay on kernel 7, in its two launches."""
    budget = softmax_lse.fused_bwd_plan(m, n, d, 132, 2, BF16)[2] - 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", budget)
        assert not softmax_lse.ce_takes_split_route(m, n, d, BF16)
    return budget


@pytest.mark.parametrize("m,n,d", CASES)
def test_two_launches_run_and_match_the_one_pass(monkeypatch, m: int, n: int, d: int) -> None:
    """Between the JAX rule and the plan, the CE gradients on bf16 towers take
    kernel 7's two launches (their twin, ``partials=False``): within
    ``ORDER_TOL`` of the one-pass twin on the same inputs (the same roundings,
    f32 sums in another order), and within ``GRAD_TOL`` of JAX's kernel 7 in
    interpret mode."""
    s, items, z, y, coeff = _inputs(m, n, d)
    one_pass = _port(s, items, z, y, coeff)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", _two_launch_budget(m, n, d))
    calls = _record_twins(monkeypatch)
    ds, di = _port(s, items, z, y, coeff)
    assert calls == [("softmax_ce_grads_from_z_bf16_reference", False)]
    assert _rel(ds, one_pass[0]) <= ORDER_TOL and _rel(di, one_pass[1]) <= ORDER_TOL
    exp_ds, exp_di = _jax(s, items, z, y, coeff)
    assert _rel(ds, exp_ds) <= GRAD_TOL and _rel(di, exp_di) <= GRAD_TOL


def test_two_launch_ds_rounds_each_step() -> None:
    """The two launches' ds rounds each 2,048-row step's sum to bf16 under
    ``BF16_DS_PARTIALS`` (each split chunk spans several steps here), as the
    one pass rounds its partials; with it off ds is one f32 sum, and di does
    not move."""
    s, items, z, y, coeff = _inputs(40, 20011, 32)
    args = [torch.from_numpy(x) for x in (s, items, z, y, coeff)]
    args[0], args[1] = args[0].to(BF16), args[1].to(BF16)
    chunks, rows = softmax_lse.split_bwd_plan(40, 20011, 32, 132, softmax_lse.FUSED_BWD_CHUNK)
    assert chunks > 1 and rows % softmax_lse.FUSED_BWD_CHUNK == 0 and rows > softmax_lse.FUSED_BWD_CHUNK
    rounded = softmax_lse.softmax_ce_grads_from_z_bf16_reference(*args, partials=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(softmax_lse, "BF16_DS_PARTIALS", False)
        plain = softmax_lse.softmax_ce_grads_from_z_bf16_reference(*args, partials=False)
    assert torch.equal(rounded[1], plain[1]) and not torch.equal(rounded[0], plain[0])
    assert _rel(rounded[0], plain[0]) <= 2 ** -8


def test_split_plan_aligns_chunks_to_steps() -> None:
    """Kernel 7's bf16 ds launch takes the split plan with its chunks a whole
    number of 2,048-row steps (its steps then start where the one pass's
    chunks start); every other split ds kernel keeps the plan's 64-row
    alignment and its grid."""
    chunk = softmax_lse.FUSED_BWD_CHUNK
    for m, n, d in ((51_200, 15_872, 128), (51_200, 65_536, 128), (51_200, 196_608, 128), (640, 301, 32),
                    (40, 20_011, 32), (25_600, 7_936, 64)):
        chunks, rows = softmax_lse.split_bwd_plan(m, n, d, 132)
        aligned, aligned_rows = softmax_lse.split_bwd_plan(m, n, d, 132, chunk)
        assert aligned_rows % chunk == 0 and aligned_rows >= rows and aligned <= chunks
        assert aligned == -(-n // aligned_rows)
    assert softmax_lse.split_bwd_plan(51_200, 15_872, 128, 132) == (4, 3_968)
    assert softmax_lse.split_bwd_plan(51_200, 15_872, 128, 132, chunk) == (4, 4_096)
    assert softmax_lse.split_bwd_plan(51_200, 65_536, 128, 132, chunk) == (4, 16_384)


# ------------------------------------------------------------------ the route at bf16


def test_route_choice_at_bf16_follows_the_plan(monkeypatch) -> None:
    """At the KION training shape (51,200 x 128) the CE gradients on bf16
    towers take the one pass up to ~63,500 items, kernel 7's two launches up
    to JAX's bf16 split at 163,840 items, the large-catalog route above; the
    plan counts kernel 7's and 12's bf16 ds partials at 2 bytes (kernel 9's
    at 4); and the CPU twins take the order the card's plan gives."""
    m, d = 51_200, 128
    assert softmax_lse.fused_bwd_plan(m, 65_536, d, 132, 2)[2] == 553_648_128
    assert softmax_lse.fused_bwd_plan(m, 61_440, d, 132, 2)[2] == 519_045_120
    assert softmax_lse._fused_on_the_card(m, 61_440, d, 2) and not softmax_lse._fused_on_the_card(m, 65_536, d, 2)
    assert not softmax_lse.ce_takes_split_route(m, 163_840, d, BF16)
    assert softmax_lse.ce_takes_split_route(m, 196_608, d, BF16)
    # a budget between the 2-byte and the 4-byte plan: kernels 7 and 12 keep their one pass, kernel 9 splits
    m, n, d = 130, 4100, 64
    two, four = (softmax_lse.fused_bwd_plan(m, n, d, 132, size)[2] for size in (2, 4))
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", (two + four) // 2)
    calls = _record_twins(monkeypatch)
    s, items, z, y, coeff = _inputs(m, n, d)
    _port(s, items, z)
    _port(s, items, z, y, coeff)
    assert calls == [("softmax_grads_from_z_bf16_reference", True), ("softmax_ce_grads_from_z_bf16_reference", True)]
    assert not softmax_lse._fused_on_the_card(m, n, d)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", two - 1)
    _port(s, items, z)
    _port(s, items, z, y, coeff)
    assert calls[2:] == [("softmax_grads_from_z_bf16_reference", False),
                         ("softmax_ce_grads_from_z_bf16_reference", False)]


def test_loss_gradients_come_back_in_bf16_rounded_once(monkeypatch) -> None:
    """Through the fused loss on bf16 towers, each route's f32 (ds, di) is
    rounded to bf16 once: the leaves' gradients equal the route's f32
    gradients of the loss cast to bf16."""
    m, n, d = 96, 3000, 32
    rng = np.random.default_rng(1)
    s = torch.from_numpy(_bf16_np(rng.normal(size=(m, d)) * 0.4)).to(BF16)
    items = torch.from_numpy(_bf16_np(rng.normal(size=(n, d)) * 0.4)).to(BF16)
    y = torch.from_numpy(rng.integers(0, n, size=m))
    w = torch.ones(m)
    for budget in (_two_launch_budget(m, n, d), 0):
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", budget)
        sg, ig = s.clone().requires_grad_(), items.clone().requires_grad_()
        losses.fused_softmax_loss(sg[None], ig, y[None], w[None]).backward()
        lse = softmax_lse.streaming_lse(s, items)
        _, _, denom = losses._ce_pieces(s, items, y, w, lse)
        c = w * (y != 0).float() / denom
        ds, di = softmax_lse.softmax_ce_grads_from_z(s, items, lse - torch.log(c), y, c)
        assert sg.grad.dtype == ig.grad.dtype == BF16
        assert torch.equal(sg.grad, ds.to(BF16)) and torch.equal(ig.grad, di.to(BF16))


# ------------------------------------------------------------------ fits


def _leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


FIT_CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5, lr=1e-3,
                  dropout_rate=0.0, get_val_mask_func=_leave_last_out)
FIT_KWARGS = {"fused_softmax_chunk": 64, "compute_dtype": "bfloat16"}
FAMILIES = {"sasrec": (JaxSASRecModel, SASRecModel), "hstu": (JaxHSTUModel, HSTUModel)}
# the partials budget of each route at the fits' shape (640 session rows, 266 catalog rows, D = 32): the two
# launches between the JAX rule's 49,152 bytes and the plan's 211,200; the large-catalog route below both
ROUTE_BUDGETS = {"two_launches": 100_000, "large_catalog": 0}


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


@pytest.fixture(scope="module")
def jax_fits():
    """JAX's bf16 SASRec and HSTU fits on the CPU (the XLA loss scan, whatever
    the budget) and their starts."""
    df = _fit_frame()
    out = {}
    for family, (jax_cls, _) in FAMILIES.items():
        model = jax_cls(**FIT_CONFIG, training_module_kwargs=FIT_KWARGS)
        model._build_model_from_dataset(JaxDataset.construct(df))
        tm = model.training_module
        first = jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32)
        tm.init_params(first)
        start = jax.tree.map(np.array, tm.params)
        tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
        out[family] = (start, tm)
    return df, out


@pytest.mark.parametrize("route", sorted(ROUTE_BUDGETS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_step_bf16_fit_through_the_route_matches_jax(jax_fits, monkeypatch, family: str, route: str) -> None:
    """3 Adam steps with bf16 compute from JAX's start, the budget forced so
    that every step's CE gradients take kernel 7's two launches or the
    large-catalog route (their twins): the train and validation losses
    follow JAX's bf16 fit."""
    df, fits = jax_fits
    start, jax_tm = fits[family]
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", ROUTE_BUDGETS[route])
    calls = _record_twins(monkeypatch)
    model = FAMILIES[family][1](**FIT_CONFIG, device="cpu", training_module_kwargs=FIT_KWARGS)
    model._build_model_from_dataset(Dataset.construct(df))
    tm = model.training_module
    tm.load_params(flax_params_to_state_dict(start))
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, 1)
    assert tm.resolved_compute_dtype == jax_tm.resolved_compute_dtype == "bfloat16"
    assert tm.global_step == jax_tm.global_step == 3
    twin = "softmax_ce_grads_from_z_bf16_reference" if route == "two_launches" else "softmax_grads_from_z_bf16_reference"
    assert calls == [(twin, False)] * 3
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=FIT_LOSS_RTOL)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=FIT_VAL_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tm.backbone.parameters())
