"""The bf16 forms of kernels 1, 4, 15 and 16 in the port, held against the
JAX package on the CPU.

Every input is made from a seed with numpy, rounded to bf16, and fed to both
sides. On the CPU the wrappers take the bf16 twins: the f32 twins on the
widened values (a product of two bf16 values is exact in f32), rounded where
the JAX kernels round. The JAX side runs its Pallas kernels in interpret mode
on bf16 inputs (``_lse_fwd_tail_kernel`` with ``_USE_PARTIALS_FWD`` set to
False inside the test, ``_lse_shift_kernel`` through ``bounded_shift=True``,
``fused_layer_norm`` and their VJPs), so both sides differ only in the order
of f32 sums. The tolerances below stand beside the largest value measured
over the cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.ops import layer_norm as jax_layer_norm
from rectools_tpu.ops import softmax_lse as jax_softmax_lse
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel, SASRecModel
from rectools_tpu_torch.ops import layer_norm, softmax_lse

BF16 = torch.bfloat16
LSE_TOL = 1e-6  # lse, relative per row, as kernel 6's bf16 twin: 5.7e-7 (kernel 16), 1.6e-7 (kernel 15)
GRAD_TOL = 2 ** -8  # the bounded-shift VJP's ds and di in bf16, relative to the largest entry: 2.0e-6 (one bf16
# step of a small entry whose f32 sum straddles a rounding boundary)
LN_TOL = 2 ** -8  # LayerNorm y, dx, dγ, dβ, relative to the largest entry, as tests/test_torch_bf16.py: 2.0e-7
# (f32 sums in another order, each rounded once)
M, N = 130, 2100  # two session blocks of 128 and two 2,048-row item chunks, the second a ragged tail of 52


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as f32 numpy (the values both sides start from)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(BF16).float().numpy()


def _t(x: np.ndarray, dtype=BF16, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).requires_grad_(grad)


def _j(x: np.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    return jnp.asarray(x, dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, expected) -> float:
    got, expected = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    return float(np.abs(got - expected).max() / np.abs(expected).max())


def _towers(d: int, scale: float, m: int = M, n: int = N, seed: int = 0):
    """bf16 towers whose logits have a spread of ``scale`` times the unit
    Gaussian's at width 32, whatever ``d``."""
    rng = np.random.default_rng(seed + d)
    width = scale / np.sqrt(d / 32)
    return _bf16_np(width * rng.normal(size=(m, d))), _bf16_np(width * rng.normal(size=(n, d)))


# ------------------------------------------------------------------ kernel 16


@pytest.mark.parametrize("scale", [0.3, 1.5])
@pytest.mark.parametrize("d", [16, 128, 256])
def test_bounded_shift_bf16_twin_matches_jax(d: int, scale: float) -> None:
    """Kernel 16's bf16 twin against JAX ``_lse_shift_kernel`` on bf16 inputs
    in interpret mode, in the same 2,048-row item chunks with a ragged tail:
    at scale 0.3 every row stays in window 1, at 1.5 every row goes to window
    2 (the sums of exp(x + 64)). The shift comes from the widened towers on
    both sides (rectools_tpu/ops/softmax_lse.py:364-365): the twin's equals
    the f32 twin's on the widened values, bit for bit."""
    s, items = _towers(d, scale)
    expected = jax_softmax_lse.streaming_lse(_j(s), _j(items), None, 128, softmax_lse.LSE_CHUNK, True, True)
    got = softmax_lse.streaming_lse(_t(s), _t(items), bounded_shift=True)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=LSE_TOL, atol=0)
    shift, l, _ = softmax_lse.lse_shift_sums_bf16_reference(_t(s), _t(items))
    window_1 = (l >= softmax_lse.WINDOW1_FLOOR).numpy()
    assert window_1.all() if scale < 1.0 else not window_1.any()
    assert torch.equal(shift, softmax_lse.lse_shift(torch.from_numpy(s), torch.from_numpy(items)))
    assert torch.equal(softmax_lse.lse_shift(_t(s), _t(items)), shift)  # bf16 towers widen before the squares


def test_bounded_shift_bf16_vjp_matches_jax() -> None:
    """The bounded-shift forward's VJP on bf16 towers (kernel 9's bf16 twin
    from the saved lse) against ``jax.grad`` of the JAX fixed-shift forward on
    bf16 inputs in interpret mode: ds and di come back in bf16, within one
    bf16 step of JAX's."""
    s, items = _towers(128, 1.0, m=45)
    dlse = np.random.default_rng(9).normal(size=45).astype(np.float32)

    def value(s_, i_):
        return jnp.sum(jax_softmax_lse.streaming_lse(s_, i_, None, 128, softmax_lse.LSE_CHUNK, True, True) * dlse)

    eds, edi = jax.grad(value, argnums=(0, 1))(_j(s), _j(items))
    ts, ti = _t(s, grad=True), _t(items, grad=True)
    (softmax_lse.streaming_lse(ts, ti, bounded_shift=True) * torch.from_numpy(dlse)).sum().backward()
    assert ts.grad.dtype == ti.grad.dtype == BF16 and eds.dtype == edi.dtype == jnp.bfloat16
    assert _rel(_np(ts.grad), _np(eds)) <= GRAD_TOL
    assert _rel(_np(ti.grad), _np(edi)) <= GRAD_TOL


# ------------------------------------------------------------------ kernel 15


@pytest.mark.parametrize("d", [16, 128, 256])
def test_carried_max_bf16_twin_matches_jax(monkeypatch, d: int) -> None:
    """Kernel 15's bf16 twin (``USE_PARTIALS_FWD = False``) against JAX
    ``_lse_fwd_tail_kernel`` on bf16 inputs in interpret mode
    (``_USE_PARTIALS_FWD`` set to False on both sides, as
    tests/ops/test_softmax_lse.py does): one running (max, Σexp) per row over
    the chunks in order, the ragged tail masked. It stays within 1e-6 of
    kernel 6's bf16 twin."""
    s, items = _towers(d, 1.0)
    monkeypatch.setattr(jax_softmax_lse, "_USE_PARTIALS_FWD", False)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", False)
    expected = jax_softmax_lse.streaming_lse(_j(s), _j(items), None, 128, softmax_lse.LSE_CHUNK, True)
    got = softmax_lse.streaming_lse(_t(s), _t(items))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=LSE_TOL, atol=0)
    assert torch.equal(got, softmax_lse.streaming_lse_carried_bf16_reference(_t(s), _t(items)))
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", True)
    np.testing.assert_allclose(softmax_lse.streaming_lse(_t(s), _t(items)).numpy(), got.numpy(), rtol=LSE_TOL)


# ------------------------------------------------------------------ kernels 1 and 4


@pytest.mark.parametrize("gamma_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,d", [(130, 128), (37, 16), (64, 256)])
def test_layer_norm_bf16_twins_match_jax(m: int, d: int, gamma_dtype: str) -> None:
    """LayerNorm on bf16 x with bf16 γ, β (the cast parameters) or f32 γ, β
    through the public autograd function, against JAX ``fused_layer_norm`` in
    interpret mode and its VJP: y and dx in bf16, dγ and dβ in γ's dtype,
    each within one bf16 step; the wrapper's results are its bf16 twins'."""
    rng = np.random.default_rng(m + d)
    x, dy = _bf16_np(rng.normal(size=(m, d)) * 2 + 0.5), _bf16_np(rng.normal(size=(m, d)))
    gamma, beta = _bf16_np(1 + 0.3 * rng.normal(size=d)), _bf16_np(0.3 * rng.normal(size=d))
    jdt, tdt = (jnp.bfloat16, BF16) if gamma_dtype == "bfloat16" else (jnp.float32, torch.float32)
    jargs = [_j(x), _j(gamma, jdt), _j(beta, jdt)]
    y_exp, vjp = jax.vjp(lambda *a: jax_layer_norm.fused_layer_norm(*a, 1e-6, 128, True), *jargs)
    dx_exp, dg_exp, db_exp = vjp(_j(dy))
    tx, tg, tb = _t(x, grad=True), _t(gamma, tdt, grad=True), _t(beta, tdt, grad=True)
    y = layer_norm.layer_norm(tx, tg, tb, 1e-6)
    y.backward(_t(dy))
    assert y.dtype == tx.grad.dtype == BF16 and tg.grad.dtype == tb.grad.dtype == tdt
    assert dg_exp.dtype == db_exp.dtype == jdt
    for name, g, e in (("y", y, y_exp), ("dx", tx.grad, dx_exp), ("dgamma", tg.grad, dg_exp),
                       ("dbeta", tb.grad, db_exp)):
        assert _rel(_np(g), _np(e)) <= LN_TOL, name
    assert torch.equal(y, layer_norm.layer_norm_bf16_reference(_t(x), _t(gamma, tdt), _t(beta, tdt)))
    twin = layer_norm.layer_norm_bwd_bf16_reference(_t(x), _t(gamma, tdt), _t(dy))
    assert all(torch.equal(g, w) for g, w in zip((tx.grad, tg.grad, tb.grad), twin))


def test_layer_norm_bf16_twins_are_the_widened_route_rounded_once() -> None:
    """The bf16 twins are the f32 twins on the widened values, y and dx
    rounded to bf16 and dγ, dβ to γ's dtype once each: what the bf16 kernels
    give on the card. f32 x with bf16 γ has no form and raises ValueError, on
    the CPU as on the card; no wrapper widens an operand."""
    rng = np.random.default_rng(5)
    x, dy = _t(rng.normal(size=(50, 32))), _t(rng.normal(size=(50, 32)))
    gamma, beta = _t(1 + rng.normal(size=32)), _t(rng.normal(size=32))
    y = layer_norm.layer_norm_fwd(x, gamma, beta)
    assert torch.equal(y, layer_norm.layer_norm_reference(x.float(), gamma.float(), beta.float()).to(BF16))
    widened = layer_norm.layer_norm_bwd_reference(x.float(), gamma.float(), dy.float())
    got = layer_norm.layer_norm_bwd(x, gamma, dy)
    assert all(g.dtype == BF16 and torch.equal(g, w.to(BF16)) for g, w in zip(got, widened))
    for call in (lambda: layer_norm.layer_norm_fwd(x.float(), gamma, beta),
                 lambda: layer_norm.layer_norm_bwd(x.float(), gamma, dy.float())):
        with pytest.raises(ValueError, match="has no kernel form"):
            call()


@pytest.mark.parametrize("family,norms", [("sasrec", 5), ("hstu", 4)])
def test_bf16_fit_runs_layer_norm_in_its_bf16_forms(monkeypatch, family: str, norms: int) -> None:
    """A 3-step bf16 fit through Model.fit takes LayerNorm's bf16 forms (here
    their twins), ``norms`` of each direction a step (SASRec: two a block and
    the closing one; HSTU: two a block), and the f32 route never: each f32
    twin call comes from inside a bf16 twin, on its widened values."""
    calls = {"fwd_bf16": 0, "bwd_bf16": 0, "fwd_f32": 0, "bwd_f32": 0}
    depth = [0]

    def counted(name, twin, inner: bool):
        def run(*args, **kwargs):
            if inner:
                calls[name] += depth[0] == 0
                return twin(*args, **kwargs)
            calls[name] += 1
            depth[0] += 1
            try:
                return twin(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    for name, attr, inner in (("fwd_bf16", "layer_norm_bf16_reference", False),
                              ("bwd_bf16", "layer_norm_bwd_bf16_reference", False),
                              ("fwd_f32", "layer_norm_reference", True),
                              ("bwd_f32", "layer_norm_bwd_reference", True)):
        monkeypatch.setattr(layer_norm, attr, counted(name, getattr(layer_norm, attr), inner))
    rng = np.random.default_rng(21)
    n = 1500
    df = pd.DataFrame({
        Columns.User: np.arange(n) % 96, Columns.Item: rng.zipf(1.2, n) % 500, Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**7, n), unit="s"),
    })
    config = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=12, dropout_rate=0.0, batch_size=32,
                  epochs=1, device="cpu", training_module_kwargs={"compute_dtype": "bfloat16"})
    if family == "hstu":
        model = HSTUModel(**config, relative_time_attention=False)
    else:
        model = SASRecModel(**config)
    model.fit(Dataset.construct(df))
    steps = model.training_module.global_step
    assert steps == 3 and np.isfinite(model.training_module.train_loss_history).all()
    assert calls == {"fwd_bf16": norms * steps, "bwd_bf16": norms * steps, "fwd_f32": 0, "bwd_f32": 0}
