"""The PyTorch port's kernels, held against the JAX package.

Every input is made from a seed with numpy and fed to both sides. The port
runs on CPU tensors, i.e. through each kernel's plain PyTorch twin; the JAX
side runs its Pallas kernel in interpret mode (and its XLA reference). The
hand-written CUDA kernels themselves are held against the twins on the card
by tests/test_torch_kernels.py and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from rectools_tpu.ops import attention as jax_attention
from rectools_tpu.ops import layer_norm as jax_layer_norm
from rectools_tpu.ops import topk as jax_topk
from rectools_tpu.ops import topk_select as jax_topk_select
from rectools_tpu_torch.ops import attention, layer_norm, topk, topk_select

MASK_VALUE = -1e9


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ LayerNorm


@pytest.mark.parametrize("m", [37, 1030])  # ragged against the 8-row tiling and the 1024-row block
@pytest.mark.parametrize("eps", [1e-6, 1e-8])
def test_layer_norm_twin_matches_jax(m: int, eps: float) -> None:
    rng = np.random.default_rng(m)
    d = 128
    x = (rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)
    gamma = rng.normal(size=(d,)).astype(np.float32)
    beta = rng.normal(size=(d,)).astype(np.float32)
    got = layer_norm.layer_norm(_t(x), _t(gamma), _t(beta), eps).numpy()
    kernel = jax_layer_norm.fused_layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps, 1024, True)
    xla = jax_layer_norm.reference_layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ attention


def _attention_inputs(b: int, h: int, l: int, dh: int, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, l, dh)).astype(np.float32) for _ in range(3))
    return q, k, v


def _causal_bias(l: int) -> np.ndarray:
    return np.where(np.tril(np.ones((l, l), dtype=bool)), 0.0, MASK_VALUE).astype(np.float32)[None, None]


def _key_padding_bias(b: int, l: int, rng: np.random.Generator) -> np.ndarray:
    lengths = rng.integers(1, l + 1, size=b)
    pad = np.arange(l)[None, :] < (l - lengths)[:, None]  # left padding
    bias = np.broadcast_to(np.where(pad, MASK_VALUE, 0.0)[:, None, None, :], (b, 1, l, l)).copy()
    bias[:, :, np.arange(l), np.arange(l)] = 0.0  # diagonal kept, as the backbone does
    return (bias + _causal_bias(l)).astype(np.float32)


@pytest.mark.parametrize("bias_kind", ["causal", "key_padding"])
def test_attention_twin_matches_jax(bias_kind: str) -> None:
    b, h, l, dh = 3, 2, 100, 16  # L=100: not a multiple of the 64-row q tile
    q, k, v = _attention_inputs(b, h, l, dh, seed=7)
    bias = _causal_bias(l) if bias_kind == "causal" else _key_padding_bias(b, l, np.random.default_rng(8))
    scale = 1.0 / np.sqrt(dh)
    out, lse = attention.attention_fwd(_t(q), _t(k), _t(v), _t(bias), scale)

    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    seed = jnp.zeros((1,), jnp.int32)
    jax_out = jax_attention.fused_attention(jq, jk, jv, jb, seed, scale, 0.0, 64, True)
    _, jax_lse = jax_attention._pallas_attention(jq, jk, jv, jb, seed, scale, 0.0, 64, interpret=True)
    ref_out, ref_lse = jax_attention._reference_attention(jq, jk, jv, jb, scale)
    for expected_out, expected_lse in ((jax_out, jax_lse), (ref_out, ref_lse)):
        np.testing.assert_allclose(out.numpy(), np.asarray(expected_out), atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(expected_lse), atol=2e-5, rtol=1e-6)


def test_dot_product_attention_blhd_layout_matches_jax() -> None:
    b, h, l, dh = 2, 4, 12, 8
    q, k, v = _attention_inputs(b, l, h, dh, seed=9)  # (B, L, H, dh)
    bias = _causal_bias(l)
    scale = 1.0 / np.sqrt(dh)
    got = attention.dot_product_attention(_t(q), _t(k), _t(v), _t(bias), scale)
    expected = jax_attention.dot_product_attention(*map(jnp.asarray, (q, k, v, bias)), scale, use_fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=2e-5)


def test_attention_rejects_dropout() -> None:
    q, k, v = (_t(a) for a in _attention_inputs(1, 1, 4, 8, seed=0))
    with pytest.raises(NotImplementedError, match="training slice"):
        attention.attention_fwd(q, k, v, None, 1.0, dropout_rate=0.2)


# ------------------------------------------------------------------ top-m / top-k


def _scores_with_ties(rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    x[:, [3, 40, 77, 127]] = 5.0  # a four-way tie inside group 0
    x[::2, 130:140] = 2.5  # ten-way tie inside group 1 on even rows
    x[1, 128:256] = 1.0  # a group that is all one value
    return x


def test_group_topm_twin_matches_jax() -> None:
    x = _scores_with_ties(6, 4 * 128, seed=11)
    x[2, 256:384] = -np.inf  # an all -inf group: lane ids meaningless there
    x[3, 400:] = -np.inf  # a partly -inf group
    m = 12
    vals, lanes = topk_select.group_topm(_t(x), m)
    jv, ji = jax_topk_select._group_topm(jnp.asarray(x.reshape(-1, 128)), m, rows_blk=8, interpret=True)
    jv, ji = np.asarray(jv).reshape(6, 4, m), np.asarray(ji).reshape(6, 4, m)
    np.testing.assert_array_equal(vals.numpy(), jv)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(lanes.numpy()[finite], ji[finite])
    assert lanes.dtype == torch.int32


@pytest.mark.parametrize("n,k", [(4096, 100), (4100, 37), (300, 20), (128, 12)])
def test_grouped_exact_top_k_matches_jax(n: int, k: int) -> None:
    x = _scores_with_ties(5, n, seed=n)
    vals, idx = topk_select.grouped_exact_top_k(_t(x), k)
    jv, ji = jax_topk_select.grouped_exact_top_k(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64


@pytest.mark.parametrize("n", [300, 4608])
def test_exact_top_k_matches_jax(n: int) -> None:
    x = np.random.default_rng(n).normal(size=(4, n)).astype(np.float32)  # no ties: orders agree
    vals, idx = topk.exact_top_k(_t(x), 25)
    jv, ji = jax_topk.exact_top_k(jnp.asarray(x), 25)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("adversarial", [True, False])
def test_certificate_route_is_observed(adversarial: bool) -> None:
    n, k = 4096, 20
    if adversarial:  # whole top-k packed into group 0: it hides k - m winners past its m kept
        x = np.repeat(np.linspace(1000.0, 1.0, n, dtype=np.float32)[None, :], 3, axis=0)
    else:
        x = np.random.default_rng(5).normal(size=(3, n)).astype(np.float32)
    _, _, suspect = topk_select.grouped_top_k_candidates(_t(x), k)
    assert bool(suspect) is adversarial

    calls = []

    def spy_fallback(s: torch.Tensor, kk: int):
        calls.append(kk)
        v, i = topk_select.sorted_top_k(s, kk)
        return v.double(), i.int()  # the route must hand back the fast path's dtypes

    vals, idx = topk_select.grouped_exact_top_k(_t(x), k, fallback=spy_fallback)
    assert calls == ([k] if adversarial else [])
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))


# ------------------------------------------------------------------ ranking


@pytest.mark.parametrize("distance", ["DOT", "COSINE", "EUCLIDEAN"])
@pytest.mark.parametrize("whitelist", [False, True])
def test_rank_topk_matches_jax(distance: str, whitelist: bool) -> None:
    rng = np.random.default_rng(21)
    n_subjects, n_objects, d, k = 40, 300, 16, 7
    subjects = rng.normal(size=(n_subjects, d)).astype(np.float32)
    objects = rng.normal(size=(n_objects, d)).astype(np.float32)
    seen = sparse.random(n_subjects, n_objects, density=0.05, format="csr", random_state=3)
    seen.data[:] = 1
    subject_ids = rng.permutation(n_subjects)[:25]
    filter_csr = seen[subject_ids]
    wl = np.sort(rng.choice(n_objects, size=120, replace=False)) if whitelist else None
    kwargs = dict(k=k, filter_pairs_csr=filter_csr, sorted_object_whitelist=wl, batch_size=8)
    got = topk.rank_topk(
        subjects, objects, subject_ids, distance=topk.Distance[distance], device="cpu", **kwargs
    )
    expected = jax_topk.rank_topk(subjects, objects, subject_ids, distance=jax_topk.Distance[distance], **kwargs)
    np.testing.assert_array_equal(got[0], expected[0])
    np.testing.assert_array_equal(got[1], expected[1])
    np.testing.assert_allclose(got[2], expected[2], rtol=1e-5, atol=1e-5)
    # nothing already seen comes back
    seen_pairs = set(zip(*seen.nonzero()))
    assert not any((s, o) in seen_pairs for s, o in zip(got[0], got[1]))


def test_rank_topk_recomputes_suspect_batches_exactly() -> None:
    # every row sorted descending: the grouped selection cannot certify k=20
    # from group 0's 12 kept values, so each batch is redone by the exact sort
    n_objects, d, k = 512, 4, 20
    objects = np.zeros((n_objects, d), np.float32)
    objects[:, 0] = np.linspace(100.0, 1.0, n_objects)
    subjects = np.abs(np.random.default_rng(1).normal(size=(10, d))).astype(np.float32) + 0.1
    got = topk.rank_topk(subjects, objects, np.arange(10), k, batch_size=4, device="cpu")
    expected = jax_topk.rank_topk(subjects, objects, np.arange(10), k, batch_size=4)
    np.testing.assert_array_equal(got[1], expected[1])
    np.testing.assert_allclose(got[2], expected[2], rtol=1e-6)
