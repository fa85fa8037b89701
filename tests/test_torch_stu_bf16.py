"""HSTU under mixed precision (``compute_dtype="bfloat16"``) in the port, held
against the JAX package on the CPU.

The port's bf16 forms of kernels 17-19 round where the JAX package's XLA route
(``_stu_reference`` and its autodiff) rounds on bf16 inputs; on the CPU their
plain twins run. Every input is made from a seed with numpy, rounded to bf16
and fed to both sides. Tolerances are relative to the largest entry, measured
here (largest over the cases) and set with headroom:

- the twins against ``_stu_reference`` and ``jax.vjp`` of it (jitted): out,
  dq, dk, dv, ds, dtw, dpw 1e-6 (the same rounding points; a product's f32 sum
  in another order flips one bf16 rounding in a few thousand entries at
  most), limit one bf16 step, 2^-8;
- the JAX Pallas route (interpret mode), which keeps s and a in f32 and sums
  dk and dv in bf16 a query block at a time: 4.5e-3 to 7.4e-3, one to two
  bf16 steps, a standing divergence (ROADMAP §3), limit 1.5e-2;
- the port's ``STULayer`` against JAX's on its TPU branch (``_stu_reference``):
  the output 7.0e-3 and the gradients 4.7e-3, limit 1e-2, except the
  output layer's bias gradient (a bf16 sum over B·L rows, rounded in other
  places by the two frameworks' linear layers), 1.5e-2, limit 3e-2; against
  JAX's layer off the TPU (its materialized branch, a standing divergence)
  4.4e-3, where JAX's two branches are 4.9e-3 apart, limit 1e-2;
- a 3-step bf16 fit against JAX's bf16 fit, whose layer off the TPU rounds
  q·kᵀ before adding the bias and keeps the attention output in f32: the
  train loss 1.6e-6 (1.2e-5 at heads of 8; limit 1e-4), the validation loss
  3.8e-5 (2.5e-5; limit 1e-3), the mean parameter gap 1.8e-5 (1.8e-5; limit
  1e-4), every entry within 2 x steps x lr (Adam moves an entry whose
  gradient is rounding noise by up to lr a step; 3.2e-3 measured, 2.2e-3).
"""

import types
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rectools_tpu.dataset import Dataset as JaxDataset
from rectools_tpu.models.nn.transformers import HSTUModel as JaxHSTUModel
from rectools_tpu.models.nn.transformers import hstu as jax_hstu
from rectools_tpu.models.nn.transformers.training import pad_batch as jax_pad_batch
from rectools_tpu.ops import stu_attention as jax_stu
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import HSTUModel
from rectools_tpu_torch.models.nn.transformers import flax_params_to_state_dict
from rectools_tpu_torch.models.nn.transformers.hstu import STULayer
from rectools_tpu_torch.ops import layer_norm, stu_attention

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
NUM_BUCKETS = 128
TWIN_TOL = 2 ** -8
PALLAS_TOL = 1.5e-2
LAYER_TOL, LAYER_BIAS_GRAD_TOL = 1e-2, 3e-2
FIT_LR = 1e-3
FIT_LOSS_RTOL, FIT_VAL_LOSS_RTOL = 1e-4, 1e-3
FIT_PARAM_TOL, FIT_PARAM_MEAN_TOL = 2 * 3 * FIT_LR, 1e-4
GRADS = ("out", "dq", "dk", "dv", "dtw", "dpw")


def _bf16_np(x) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(BF16).float().numpy()


def _rel(got, expected) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(jnp.asarray(got, jnp.float32))
    expected = np.asarray(jnp.asarray(expected, jnp.float32))
    return float(np.abs(got.astype(np.float64) - expected).max() / np.abs(expected).max())


def _inputs(b: int, h: int, l: int, ad: int, lh: int, seed: int) -> dict:
    """q, k (B, H, L, ad), v, dout (B, H, L, lh) and both tables in bf16 values,
    int32 timestamps (B, L + 2), a left-padded timeline whose last row is all
    padding, the causal mask."""
    rng = np.random.default_rng(seed)
    q, k = (_bf16_np(0.5 * rng.normal(size=(b, h, l, ad))) for _ in range(2))
    v, dout = (_bf16_np(0.5 * rng.normal(size=(b, h, l, lh))) for _ in range(2))
    ts = 1_600_000_000 + np.cumsum(rng.integers(1, 3 * 86400, size=(b, l + 2)), axis=1)
    timeline = (np.arange(l)[None, :] >= rng.integers(0, l, size=(b, 1))).astype(np.float32)
    timeline[0], timeline[-1] = 1.0, 0.0
    return dict(q=q, k=k, v=v, dout=dout, tw=_bf16_np(0.3 * rng.normal(size=NUM_BUCKETS + 1)),
                pw=_bf16_np(0.3 * rng.normal(size=2 * l - 1)), ts=ts.astype(np.int32), timeline=timeline,
                allowed=np.tril(np.ones((l, l), np.float32)))


def _port_grads(x: dict, use_time: bool, use_pos: bool) -> list:
    """The port's autograd Function on bf16 leaves: out and the gradients of
    q, k, v and the two bf16 tables."""
    leaf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(BF16).requires_grad_()  # noqa: E731
    q, k, v = leaf(x["q"]), leaf(x["k"]), leaf(x["v"])
    tw = leaf(x["tw"]) if use_time else None
    pw = leaf(x["pw"]) if use_pos else None
    l = q.shape[2]
    buckets = stu_attention.time_buckets(torch.from_numpy(x["ts"]), l, NUM_BUCKETS) if use_time else None
    out = stu_attention.stu_attention(q, k, v, buckets, torch.from_numpy(x["timeline"]),
                                      torch.from_numpy(x["allowed"])[None], tw, pw)
    out.backward(torch.from_numpy(x["dout"]).to(BF16))
    return [out, q.grad, k.grad, v.grad, None if tw is None else tw.grad, None if pw is None else pw.grad]


def _jax_reference_grads(x: dict, use_time: bool, use_pos: bool) -> list:
    """``_stu_reference`` on bf16 q, k, v and tables, jitted, and its VJP."""
    def f(q, k, v, tw, pw):
        return jax_stu._stu_reference(q, k, v, jnp.asarray(x["ts"]), jnp.asarray(x["timeline"], JBF16), tw, pw,
                                      jnp.asarray(x["allowed"], JBF16), NUM_BUCKETS, use_time, use_pos)

    def with_vjp(*args):
        out, vjp = jax.vjp(f, *args)
        return (out, *vjp(jnp.asarray(x["dout"], JBF16)))

    return list(jax.jit(with_vjp)(*(jnp.asarray(x[n], JBF16) for n in ("q", "k", "v", "tw", "pw"))))


# ------------------------------------------------------------------ the twins against JAX's XLA route


BIASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize(
    "l,ad,lh,use_time,use_pos",
    [(100, 16, 32, *b) for b in BIASES] + [(77, 32, 16, *b) for b in BIASES] + [(257, 16, 16, True, True)]
    + [(100, 8, 8, True, True), (77, 8, 16, True, False), (100, 16, 8, False, True)],
)
def test_twins_match_jax_reference(l: int, ad: int, lh: int, use_time: bool, use_pos: bool) -> None:
    """Kernels 17 and 18's twins and the table gradients from kernel 19's
    against ``_stu_reference`` and its VJP: L = 100, L = 77 (no multiple of
    64) and L = 257 (whose bf16 is 256: both sides divide by it), with and
    without each bias, and at dims of 8 (HSTU's n_factors 32 with 4 heads)."""
    b, h = (2, 1) if l > 200 else (3, 2)
    x = _inputs(b, h, l, ad, lh, seed=l + ad)
    got = _port_grads(x, use_time, use_pos)
    expected = _jax_reference_grads(x, use_time, use_pos)
    assert got[0].dtype == BF16 and all(g.dtype == BF16 for g in got[1:] if g is not None)
    for name, g, e in zip(GRADS, got, expected):
        if g is None:
            continue
        assert _rel(g, e) <= TWIN_TOL, (name, _rel(g, e))
    assert not got[0][-1].any()  # the fully padded batch row


@pytest.mark.parametrize("l", [100, 77])
def test_ds_twin_matches_jax_bias_gradient(l: int, monkeypatch: pytest.MonkeyPatch) -> None:
    """Kernel 19's twin (ds summed over heads, f32) against the cotangent
    ``_stu_reference`` gives a (B, L, L) bias: the JAX lookup is replaced by
    the bias itself, so the VJP returns the head sum of ds at full size. Its
    bucket sums, cast to bf16, are the time table's gradient."""
    x = _inputs(3, 2, l, 32, 32, seed=l + 1)
    buckets = stu_attention.time_buckets(torch.from_numpy(x["ts"]), l, NUM_BUCKETS)
    bias = stu_attention.combined_bias(buckets, torch.from_numpy(x["tw"]), torch.from_numpy(x["pw"]), l,
                                       torch.device("cpu"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(BF16)  # noqa: E731
    ds, sums = stu_attention.stu_ds(t(x["q"]), t(x["k"]), t(x["v"]), bias, torch.from_numpy(x["allowed"])[None],
                                    torch.from_numpy(x["timeline"]), t(x["dout"]), buckets, NUM_BUCKETS + 1)
    assert ds.dtype == sums.dtype == torch.float32
    monkeypatch.setattr(jax_stu, "_bucket_bias", lambda full_bias, _buckets: full_bias)

    def cotangent(full_bias):
        def f(fb):
            return jax_stu._stu_reference(*(jnp.asarray(x[n], JBF16) for n in ("q", "k", "v")), jnp.asarray(x["ts"]),
                                          jnp.asarray(x["timeline"], JBF16), fb, None,
                                          jnp.asarray(x["allowed"], JBF16), NUM_BUCKETS, True, False)

        return jax.vjp(f, full_bias)[1](jnp.asarray(x["dout"], JBF16))[0]

    expected = jax.jit(cotangent)(jnp.asarray(bias.numpy()))
    assert _rel(ds, expected) <= TWIN_TOL
    monkeypatch.undo()
    dtw = jax_stu._bucket_bias_bwd((jnp.asarray(buckets.numpy()), jnp.zeros(NUM_BUCKETS + 1, JBF16)), expected)[0]
    assert _rel(sums.to(BF16), dtw) <= TWIN_TOL


# ------------------------------------------------------------------ the Pallas route's gap


def test_pallas_route_gap_is_a_standing_divergence() -> None:
    """JAX's Pallas route (``_stu_pallas`` / ``_stu_pallas_bwd`` in interpret
    mode, 32-query blocks, so dk and dv are summed in bf16 over four blocks)
    against the twins: one to two bf16 steps apart, held below PALLAS_TOL."""
    l = 100
    x = _inputs(2, 2, l, 32, 32, seed=107)
    got = _port_grads(x, True, True)
    qkv = [jnp.asarray(x[n], JBF16) for n in ("q", "k", "v")]
    common = (jnp.asarray(x["ts"]), jnp.asarray(x["timeline"]), jnp.asarray(x["tw"], JBF16),
              jnp.asarray(x["pw"], JBF16), jnp.asarray(x["allowed"])[None])
    out = jax_stu._stu_pallas(*qkv, *common, NUM_BUCKETS, True, True, 32, interpret=True)
    grads = jax_stu._stu_pallas_bwd(*qkv, *common, jnp.asarray(x["dout"], JBF16), NUM_BUCKETS, True, True, 32,
                                    interpret=True)
    gaps = {name: _rel(g, e) for name, g, e in zip(GRADS, got, (out, *grads))}
    assert all(gap <= PALLAS_TOL for gap in gaps.values()), gaps
    assert max(gaps.values()) > TWIN_TOL, gaps  # a divergence: the twins follow the XLA route


# ------------------------------------------------------------------ the layer


def test_layer_matches_jax_layer_on_its_tpu_branch(monkeypatch: pytest.MonkeyPatch) -> None:
    """``STULayer`` in bf16 against JAX's ``STULayer`` on the branch its TPU
    takes (``stu_dot_product_attention``, here ``_stu_reference``), output and
    every gradient: the uvqk projection summed and SiLU'd in f32 and rounded
    once, the attention output bf16. The output is also held against JAX's
    layer on the branch it takes off the TPU."""
    b, l, d, h = 4, 20, 32, 2
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, l + 1, size=b)
    lengths[0] = l
    timeline = (np.arange(l)[None, :] >= (l - lengths)[:, None]).astype(np.float32)
    seqs = _bf16_np(rng.normal(size=(b, l, d))) * timeline[:, :, None]
    ts = 1_600_000_000 + np.sort(rng.integers(0, 10**6, size=(b, l + 1)), axis=1)
    dy = _bf16_np(rng.normal(size=(b, l, d)))
    allowed = np.tril(np.ones((l, l), np.float32))[None, None]
    module = jax_hstu.STULayer(n_factors=d, n_heads=h, linear_hidden_dim=d // h, attention_dim=d // h,
                               session_max_len=l, relative_time_attention=True, relative_pos_attention=True,
                               attn_dropout_rate=0.0, dropout_rate=0.0, epsilon=1e-6)
    batch = {"unix_ts": jnp.asarray(ts), "x": jnp.zeros((b, l), jnp.int32)}
    shapes = module.init(jax.random.PRNGKey(0), jnp.asarray(seqs), batch, jnp.asarray(allowed),
                         jnp.asarray(timeline[:, :, None]))["params"]

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", ""), np.shape(leaf)
        if name == "scale":
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        if name in ("bias", "time_weights", "pos_weights"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, shapes))
    tpu = types.SimpleNamespace(**{n: getattr(jax, n) for n in dir(jax) if not n.startswith("__")})
    tpu.default_backend = lambda: "tpu"
    monkeypatch.setattr(jax_hstu, "jax", tpu)

    def f(p, s):
        return module.apply({"params": p}, s, batch, jnp.asarray(allowed, JBF16),
                            jnp.asarray(timeline[:, :, None], JBF16))

    params_bf16 = jax.tree.map(lambda a: jnp.asarray(a, JBF16), params)
    y_exp, vjp = jax.vjp(f, params_bf16, jnp.asarray(seqs, JBF16))
    grads_exp, dx_exp = vjp(jnp.asarray(dy, JBF16))
    monkeypatch.undo()
    y_cpu_branch = f(params_bf16, jnp.asarray(seqs, JBF16))  # off the TPU: the materialized branch, f32 out
    expected = {"y": y_exp, "dx": dx_exp,
                **flax_params_to_state_dict(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), grads_exp))}

    layer = STULayer(d, h, d // h, d // h, l, True, True, 0.0, 0.0, 1e-6)
    layer.load_state_dict(flax_params_to_state_dict(params))
    layer = layer.to(BF16)
    x = torch.from_numpy(seqs).to(BF16).requires_grad_()
    y = layer(x, {"unix_ts": torch.from_numpy(ts)}, torch.from_numpy(allowed).to(BF16),
              torch.from_numpy(timeline[:, :, None]).to(BF16))
    y.backward(torch.from_numpy(dy).to(BF16))
    got = {"y": y, "dx": x.grad, **{name: p.grad for name, p in layer.named_parameters()}}
    assert y.dtype == BF16 and got.keys() == expected.keys()
    for name, g in got.items():
        e = expected[name]
        e = e.numpy() if isinstance(e, torch.Tensor) else e
        limit = LAYER_BIAS_GRAD_TOL if name == "output_mlp.bias" else LAYER_TOL
        assert _rel(g, e) <= limit, (name, _rel(g, e))
    # JAX's layer off the TPU rounds q·kᵀ before the bias and keeps the attention output in f32: a standing
    # divergence of the same size as the gap between JAX's own two branches
    assert y_cpu_branch.dtype == jnp.float32
    assert _rel(y, y_cpu_branch) <= LAYER_TOL and _rel(y_exp, y_cpu_branch) <= LAYER_TOL


# ------------------------------------------------------------------ fits


def _leave_last_out(interactions: pd.DataFrame) -> np.ndarray:
    """Validation mask: the last interaction of every fourth user."""
    last = interactions.groupby(Columns.User)[Columns.Datetime].transform("max")
    return ((interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 4 == 0)).to_numpy()


FIT_CONFIG = dict(n_blocks=2, n_heads=2, n_factors=32, session_max_len=20, batch_size=32, epochs=1, seed=5, lr=FIT_LR,
                  dropout_rate=0.0, get_val_mask_func=_leave_last_out)
FIT_KWARGS = {"fused_softmax_chunk": 64, "compute_dtype": "bfloat16"}


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


# heads of 8: attention and hidden dims n_factors / n_heads = 8
HEADS_OF_8 = dict(n_factors=16, n_heads=2)


def _jax_hstu_fit(width: tp.Optional[dict] = None):
    """JAX's bf16 HSTU fit on the CPU (its layer's materialized branch) and its start."""
    df = _fit_frame()
    model = JaxHSTUModel(**{**FIT_CONFIG, **(width or {})}, training_module_kwargs=FIT_KWARGS)
    model._build_model_from_dataset(JaxDataset.construct(df))
    tm = model.training_module
    tm.init_params(jax_pad_batch(next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0)))), 32))
    start = jax.tree.map(np.array, tm.params)
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, max_epochs=1)
    return df, start, tm


@pytest.fixture(scope="module")
def jax_fit():
    return _jax_hstu_fit()


def _port_model(df: pd.DataFrame, start, compute_dtype: str = "bfloat16", **kwargs) -> HSTUModel:
    model = HSTUModel(**{**FIT_CONFIG, **kwargs}, device="cpu",
                      training_module_kwargs={**FIT_KWARGS, "compute_dtype": compute_dtype})
    model._build_model_from_dataset(Dataset.construct(df))
    model.training_module.load_params(flax_params_to_state_dict(start))
    return model


def _fit(model: HSTUModel):
    tm = model.training_module
    tm.fit(model.data_preparator.get_dataloader_train, model.data_preparator.get_dataloader_val, 1)
    return tm


def test_three_step_hstu_bf16_fit_matches_jax(jax_fit) -> None:
    """3 Adam steps of HSTU (time and position biases) with bf16 compute from
    the same converted start: losses and the f32 master parameters follow
    JAX's bf16 fit."""
    df, start, jax_tm = jax_fit
    _check_against_jax_fit(_port_model(df, start), jax_tm)


def test_three_step_hstu_bf16_fit_at_heads_of_8_matches_jax() -> None:
    """The same at n_factors 16 with 2 heads: kernels 17-19's bf16 forms at
    attention and hidden dims of 8 (here their twins)."""
    df, start, jax_tm = _jax_hstu_fit(HEADS_OF_8)
    model = _port_model(df, start, **HEADS_OF_8)
    assert model.backbone.transformer_layers.blocks[0].attention_dim == 8
    _check_against_jax_fit(model, jax_tm)


def _check_against_jax_fit(model: HSTUModel, jax_tm) -> None:
    tm = _fit(model)
    assert tm.resolved_compute_dtype == jax_tm.resolved_compute_dtype == "bfloat16"
    assert tm.global_step == jax_tm.global_step == 3
    np.testing.assert_allclose(tm.train_loss_history, jax_tm.train_loss_history, rtol=FIT_LOSS_RTOL)
    np.testing.assert_allclose(tm.val_loss_history, jax_tm.val_loss_history, rtol=FIT_VAL_LOSS_RTOL)
    expected = flax_params_to_state_dict(jax.tree.map(np.array, jax_tm.params))
    diffs = []
    for name, value in model.backbone.state_dict().items():
        assert value.dtype == torch.float32, name
        err = (value - expected[name]).abs()
        diffs.append(err.reshape(-1))
        assert err.max().item() <= FIT_PARAM_TOL, name
    assert torch.cat(diffs).mean().item() <= FIT_PARAM_MEAN_TOL


def test_hstu_bf16_fit_tracks_the_f32_fit(jax_fit) -> None:
    """The bf16 fit's losses within 2e-2 of the port's f32 fit from the same
    start, and not equal to them."""
    df, start, _ = jax_fit
    bf16 = _fit(_port_model(df, start))
    f32 = _fit(_port_model(df, start, "float32"))
    np.testing.assert_allclose(bf16.train_loss_history, f32.train_loss_history, rtol=2e-2)
    np.testing.assert_allclose(bf16.val_loss_history, f32.val_loss_history, rtol=2e-2)
    assert bf16.train_loss_history != f32.train_loss_history


def test_hstu_bf16_step_reaches_the_bf16_twins_only(jax_fit, monkeypatch: pytest.MonkeyPatch) -> None:
    """A bf16 HSTU train step runs the bf16 twins of kernels 17-19 (one each
    per block, 18's twin standing for its two launches) and no f32 STU twin;
    LayerNorm takes its f32 twins through the wrapper."""
    calls = []
    for module, names in ((stu_attention, ("stu_reference", "stu_bwd_reference", "stu_ds_reference",
                                           "stu_bf16_reference", "stu_bwd_bf16_reference", "stu_ds_bf16_reference")),
                          (layer_norm, ("layer_norm_reference", "layer_norm_bwd_reference"))):
        for name in names:
            twin = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, _n=name, _t=twin, **k: calls.append(_n) or _t(*a, **k))
    df, start, _ = jax_fit
    model = _port_model(df, start, dropout_rate=0.2)
    tm = model.training_module
    batch = next(iter(model.data_preparator.get_dataloader_train(np.random.default_rng(0))))
    tm._train_step(tm._device_batch(batch))
    n = FIT_CONFIG["n_blocks"]
    assert calls.count("stu_bf16_reference") == calls.count("stu_bwd_bf16_reference") == n
    assert calls.count("stu_ds_bf16_reference") == n
    assert not {"stu_reference", "stu_bwd_reference", "stu_ds_reference"} & set(calls)
    assert calls.count("layer_norm_reference") == calls.count("layer_norm_bwd_reference") == 2 * n
    assert all(p.dtype == torch.float32 for p in tm.backbone.parameters())


# ------------------------------------------------------------------ refusals


def _small(dtype=BF16, d: int = 16):
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)  # noqa: E731
    l = 6
    return (t(1, 2, l, d), t(1, 2, l, d), t(1, 2, l, d), torch.zeros((1, l, l)), torch.ones((1, l, l)),
            torch.ones((1, l)), t(1, 2, l, d))


def test_wrappers_refuse_mixed_dtypes() -> None:
    """Each STU wrapper takes one operand dtype for q, k, v and dout: a bf16 /
    f32 set raises TypeError, on the CPU as on the card."""
    q, k, v, bias, allowed, timeline, dout = _small()
    mixed = {
        "stu_fwd": lambda: stu_attention.stu_fwd(q, k.float(), v, bias, allowed, timeline),
        "stu_bwd": lambda: stu_attention.stu_bwd(q, k, v, bias, allowed, timeline, dout.float()),
        "stu_ds": lambda: stu_attention.stu_ds(q.float(), k, v, bias, allowed, timeline, dout),
    }
    for what, call in mixed.items():
        with pytest.raises(TypeError, match="mixed operand dtypes"):
            call()


def test_head_dim_8_raises_naming_the_roadmap() -> None:
    """bf16 at a head dim of 8, which raised NotImplementedError before the
    bf16 forms took it, now runs: kernels 17 and 18 at (ad, lh) = (8, 8)
    against ``_stu_reference`` and its VJP (19's ds at 8 is held to JAX
    through the table gradients of ``test_twins_match_jax_reference``), f32
    at that dim as before, and an HSTU fit (n_factors 16, 2 heads) to a
    finite loss in bf16."""
    q, k, v, bias, allowed, timeline, dout = _small(d=8)
    out = stu_attention.stu_fwd(q, k, v, bias, allowed, timeline)
    dq, dk, dv = stu_attention.stu_bwd(q, k, v, bias, allowed, timeline, dout)
    ds, _ = stu_attention.stu_ds(q, k, v, bias, allowed, timeline, dout)
    assert out.dtype == dq.dtype == BF16 and ds.dtype == torch.float32
    l = q.shape[2]

    def f(q_, k_, v_):
        return jax_stu._stu_reference(q_, k_, v_, jnp.zeros((1, l + 1), jnp.int32), jnp.asarray(timeline, JBF16),
                                      None, None, jnp.asarray(allowed[0], JBF16), NUM_BUCKETS, False, False)

    def with_vjp(*args):
        y, vjp = jax.vjp(f, *args)
        return (y, *vjp(jnp.asarray(dout.float().numpy(), JBF16)))

    expected = jax.jit(with_vjp)(*(jnp.asarray(t.float().numpy(), JBF16) for t in (q, k, v)))
    for name, g, e in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv), expected):
        assert _rel(g, e) <= TWIN_TOL, (name, _rel(g, e))
    assert stu_attention.stu_fwd(*(a.float() for a in (q, k, v, bias, allowed, timeline))).dtype == torch.float32
    dataset = Dataset.construct(_fit_frame())
    hstu = HSTUModel(n_blocks=1, n_heads=2, n_factors=16, session_max_len=6, epochs=1, batch_size=8, device="cpu",
                     training_module_kwargs={"compute_dtype": "bfloat16"})
    hstu.fit(dataset)
    assert hstu.training_module.resolved_compute_dtype == "bfloat16"
    assert np.isfinite(hstu.training_module.train_loss_history).all()
