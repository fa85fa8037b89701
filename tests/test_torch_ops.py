"""The PyTorch port's kernels, held against the JAX package.

Every input is made from a seed with numpy and fed to both sides. The port
runs on CPU tensors, i.e. through each kernel's plain PyTorch twin; the JAX
side runs its Pallas kernel in interpret mode (and its XLA reference). The
hand-written CUDA kernels themselves are held against the twins on the card
by tests/test_torch_kernels.py and by ``chip_smoke.py``.
"""

import typing as tp

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


@pytest.mark.parametrize("bias_kind", ["causal", "key_padding", "masked_row"])
def test_attention_twin_matches_jax(bias_kind: str) -> None:
    """``masked_row``: the causal bias with query row 37 masked everywhere.
    Its lse rounds to its max (about MASK_VALUE), so p = exp(s - lse) is 1
    for every key. The JAX package's two paths part there: its XLA path (the
    one it takes below L = 256) and both packages' backward use that p, and
    the output is the sum of v; its Pallas kernel divides by the sum of p
    and gives the mean of v. The twin (and the port's kernels) take the XLA
    path's value; every other row and every lse agree with both paths."""
    b, h, l, dh = 3, 2, 100, 16  # L=100: not a multiple of the 64-row q tile
    q, k, v = _attention_inputs(b, h, l, dh, seed=7)
    bias = _causal_bias(l) if bias_kind == "causal" else _key_padding_bias(b, l, np.random.default_rng(8))
    rows = np.ones(l, dtype=bool)  # the rows held against both JAX paths
    if bias_kind == "masked_row":
        bias = _causal_bias(l)
        bias[..., 37, :] = MASK_VALUE
        rows[37] = False
    scale = 1.0 / np.sqrt(dh)
    out, lse = attention.attention_fwd(_t(q), _t(k), _t(v), _t(bias), scale)

    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    seed = jnp.zeros((1,), jnp.int32)
    jax_out = jax_attention.fused_attention(jq, jk, jv, jb, seed, scale, 0.0, 64, True)
    _, jax_lse = jax_attention._pallas_attention(jq, jk, jv, jb, seed, scale, 0.0, 64, interpret=True)
    ref_out, ref_lse = jax_attention._reference_attention(jq, jk, jv, jb, scale)
    for expected_out, expected_lse in ((jax_out, jax_lse), (ref_out, ref_lse)):
        np.testing.assert_allclose(out.numpy()[:, :, rows], np.asarray(expected_out)[:, :, rows], atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(expected_lse), atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    if bias_kind == "masked_row":
        np.testing.assert_allclose(out.numpy()[:, :, 37], v.sum(axis=2), atol=2e-5)
        np.testing.assert_allclose(np.asarray(jax_out)[:, :, 37], v.mean(axis=2), atol=2e-5)


def test_dot_product_attention_blhd_layout_matches_jax() -> None:
    b, h, l, dh = 2, 4, 12, 8
    q, k, v = _attention_inputs(b, l, h, dh, seed=9)  # (B, L, H, dh)
    bias = _causal_bias(l)
    scale = 1.0 / np.sqrt(dh)
    got = attention.dot_product_attention(_t(q), _t(k), _t(v), _t(bias), scale)
    expected = jax_attention.dot_product_attention(*map(jnp.asarray, (q, k, v, bias)), scale, use_fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=2e-5)


def test_attention_rejects_dropout() -> None:
    """Dropout needs a seed (as in the JAX entry point) and a rate below 1."""
    q, k, v = (_t(a) for a in _attention_inputs(1, 4, 1, 8, seed=0))  # (B, L, H, dh)
    with pytest.raises(ValueError, match="dropout_seed"):
        attention.dot_product_attention(q, k, v, None, 1.0, dropout_rate=0.2)
    with pytest.raises(ValueError, match="dropout_seed"):
        jax_attention.dot_product_attention(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), None, 1.0,
                                            dropout_rate=0.2)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        attention._dropout_args(0, 1.0)


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



def _select_model(group: np.ndarray, m: int) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The thread-per-group top-m kernel (csrc/topk_select.cu, m <= 16) on one
    (128,) group, step by step: the threshold is the m-th largest of the 32
    four-lane chunk maxima, raised to the largest finite negative float; the
    candidates are the lanes at or above it, in lane order; each goes into a
    sorted list of M (4, 8, 12 or 16) >= m (value, lane) pairs that starts as
    (-inf, 0), above the first entry it is strictly greater than, the entries
    below moving down one slot. Returns the first m values and lanes."""
    size = next(s for s in (4, 8, 12, topk_select.SELECT_MAX_M) if m <= s)
    chunk_max = -np.sort(-group.reshape(32, 4).max(axis=1))
    threshold = max(chunk_max[m - 1], np.finfo(np.float32).min)
    vals, lanes = [np.float32(-np.inf)] * size, [0] * size
    for lane in np.flatnonzero(group >= threshold):
        value, place, shift = group[lane], int(lane), False
        for j in range(size):
            take = shift or value > vals[j]
            if take:
                vals[j], value = value, vals[j]
                lanes[j], place = place, lanes[j]
            shift = take
    return np.asarray(vals[:m], np.float32), np.asarray(lanes[:m], np.int32)


def _topm_groups(m: int, seed: int) -> np.ndarray:
    """(rows, 128) groups for the selection's edge cases: N(0, 1) scores,
    coarse ties, 128 equal values, 0, 1, 3, m - 1 and m finite values among
    -inf, ties straddling the m-th slot, +inf values, a chunk of four equal
    maxima, and all -inf."""
    rng = np.random.default_rng(seed)
    rows = [rng.normal(size=128), np.round(rng.normal(size=128), 1), np.full(128, 0.7)]
    for n_finite in sorted({0, 1, 3, max(m - 1, 0), m}):
        row = np.full(128, -np.inf)
        row[rng.choice(128, n_finite, replace=False)] = rng.normal(size=n_finite)
        rows.append(row)
    straddle = rng.normal(size=128) - 10.0  # m - 2 larger values, then 6 ties over slots m - 1 .. m + 4
    straddle[rng.choice(128, max(m - 2, 0), replace=False)] = 5.0 + np.arange(max(m - 2, 0))
    below = np.flatnonzero(straddle < 0)
    straddle[rng.choice(below, min(6, below.size), replace=False)] = 1.0
    rows.append(straddle)
    inf = rng.normal(size=128)
    inf[[5, 77, 100]] = np.inf
    rows.append(inf)
    chunk = rng.normal(size=128)
    chunk[12:16] = 9.0
    rows.append(chunk)
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("m", [1, 5, 12, 16])
def test_group_topm_select_model_matches_twin_and_jax(m: int) -> None:
    """The CUDA selection's order of work for m <= 16, as a numpy model, equals
    the twin and the JAX kernel (interpret mode) in every value and lane id,
    the (-inf, lane 0) slots past a group's finite values included: the
    threshold keeps every element of the top m and the insertion keeps the
    lowest lane first among equal values."""
    x = _topm_groups(m, seed=m)
    model = [_select_model(row, m) for row in x]
    ref_vals, ref_lanes = topk_select.group_topm_reference(_t(x), m)
    jv, ji = jax_topk_select._group_topm(jnp.asarray(x), m, rows_blk=8, interpret=True)
    for got in ((np.stack([v for v, _ in model]), np.stack([l for _, l in model])),
                (np.asarray(jv), np.asarray(ji))):
        np.testing.assert_array_equal(got[0], ref_vals.numpy()[:, 0])
        np.testing.assert_array_equal(got[1], ref_lanes.numpy()[:, 0])
    assert np.isneginf(ref_vals.numpy()[3]).all() and not ref_lanes.numpy()[3].any()  # all -inf: lane 0 everywhere


def _sort_model(group: np.ndarray, m: int) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The sorting top-m kernel (csrc/topk_select.cu, 16 < m <= 128) on one
    (128,) group, step by step: position p = 16 l + s is register s of lane l
    of the group's eight, loaded with column 4 (l + 8 (s // 4)) + s % 4; the
    bitonic network's stage (K, J) compares p with p ^ J, the lower position
    keeping the earlier pair (the larger value, then the lower lane; a float
    compare) where p & K is clear and the later one where it is set. The
    first m positions are stored, a -inf value with lane 0."""
    pos = np.arange(128)
    vals = group[4 * (pos // 16 + 8 * (pos % 16 // 4)) + pos % 4].astype(np.float32)
    lanes = (4 * (pos // 16 + 8 * (pos % 16 // 4)) + pos % 4).astype(np.int32)
    k = 2
    while k <= 128:
        j = k // 2
        while j > 0:
            for p in range(128):
                q = p ^ j
                if q < p:
                    continue
                later_first = vals[q] > vals[p] or (vals[q] == vals[p] and lanes[q] < lanes[p])
                if later_first == ((p & k) == 0):
                    vals[p], vals[q] = vals[q], vals[p]
                    lanes[p], lanes[q] = lanes[q], lanes[p]
            j //= 2
        k *= 2
    out_vals, out_lanes = vals[:m].copy(), lanes[:m].copy()
    out_lanes[np.isneginf(out_vals)] = 0
    return out_vals, out_lanes


def _cocount_groups(seed: int) -> np.ndarray:
    """(4, 128) groups of plain co-counts, as ItemKNN truncates them:
    non-negative integers, about 90% zeros (ties straddle every m past the
    non-zeros), one with 60 non-zeros of 1 to 3 (ties straddle the m-th slot
    among them), one all zeros and one with a few -inf columns (the padding
    past the catalog's end)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((4, 128), np.float32)
    rows[0, rng.choice(128, 13, replace=False)] = rng.integers(1, 6, 13)
    rows[1, rng.choice(128, 60, replace=False)] = rng.integers(1, 4, 60)
    rows[3, rng.choice(128, 12, replace=False)] = rng.integers(1, 9, 12)
    rows[3, 120:] = -np.inf
    return rows


@pytest.mark.parametrize("m", [17, 33, 50, 64, 127, 128])
def test_group_topm_sort_model_matches_twin_and_jax(m: int) -> None:
    """The CUDA sorting kernel's order of work for m > 16, as a numpy model,
    equals the twin and the JAX kernel (interpret mode) in every value and
    lane id on the selection's edge cases and on co-count groups: the network
    sorts (value, lane) pairs into one total order, however many values tie
    at the m-th slot, and the slots past a group's values above -inf read
    (-inf, lane 0)."""
    x = np.concatenate([_topm_groups(m, seed=m), _cocount_groups(seed=m)])
    model = [_sort_model(row, m) for row in x]
    ref_vals, ref_lanes = topk_select.group_topm_reference(_t(x), m)
    jv, ji = jax_topk_select._group_topm(jnp.asarray(x), m, rows_blk=8, interpret=True)
    for got in ((np.stack([v for v, _ in model]), np.stack([l for _, l in model])),
                (np.asarray(jv), np.asarray(ji))):
        np.testing.assert_array_equal(got[0], ref_vals.numpy()[:, 0])
        np.testing.assert_array_equal(got[1], ref_lanes.numpy()[:, 0])
    assert np.isneginf(ref_vals.numpy()[3]).all() and not ref_lanes.numpy()[3].any()  # all -inf: lane 0 everywhere
    cocount = ref_vals.numpy()[-4:, 0]
    assert (cocount[0, 13:] == 0).all() and (cocount[2] == 0).all()  # runs of tied zeros reach the m-th slot


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

    before = topk_select.FALLBACKS["exact_top_k"]
    vals, idx = topk_select.grouped_exact_top_k(_t(x), k, fallback=spy_fallback)
    assert calls == ([k] if adversarial else [])
    assert topk_select.FALLBACKS["exact_top_k"] - before == len(calls)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))


def _tie_case(case: str) -> tp.Tuple[np.ndarray, int, tp.Optional[int], bool]:
    """(scores, k, m or None for pick_m, whether the certificate must fail)."""
    rng = np.random.default_rng(9)
    x = np.zeros((3, 4096), np.float32)
    if case == "ties_past_the_kth":  # every group's m-th kept is a zero past the k-th's index
        x[:, :3] = [3.0, 2.0, 1.0]
        return x, 5, None, False
    if case == "ties_hidden_in_group_0":  # group 0 keeps 12 zeros; the top 20 needs 19 of them
        x[:, 200] = 1.0
        return x, 20, None, True
    if case == "fewer_finite_than_k":  # the k-th is -inf, where the kernel's lanes repeat lane 0
        x[:] = -np.inf
        x[:, [0, 200, 300]] = [1.0, 2.0, 3.0]
        return x, 5, 5, True
    if case == "tied_zeros_m_is_k":  # ItemKNN's truncation: few co-counts a row, K = 50
        x = ((rng.random((3, 4096)) < 0.005) * rng.integers(1, 4, size=(3, 4096))).astype(np.float32)
        return x, 50, 50, False
    # the whole top k in group 0, and ties: m = k keeps all of it
    x = np.repeat(np.floor(np.linspace(40.0, 1.0, 4096, dtype=np.float32))[None, :], 3, axis=0)
    return x, 50, 50, False


@pytest.mark.parametrize("case", ["ties_past_the_kth", "ties_hidden_in_group_0", "fewer_finite_than_k",
                                  "tied_zeros_m_is_k", "crowded_m_is_k"])
def test_certificate_reads_ties_by_index(case: str) -> None:
    """A group's m-th kept element hides nothing unless it comes before the
    provisional k-th (a greater value, or an equal one at a lower index): ties
    past the k-th pass, and with m >= k no input with a finite k-th fails. A
    tie at -inf always fails. Either way the result is ``lax.top_k``'s."""
    x, k, m, must_fail = _tie_case(case)
    _, _, suspect = topk_select.grouped_top_k_candidates(_t(x), k, m)
    assert bool(suspect) is must_fail
    before = topk_select.FALLBACKS["exact_top_k"]
    vals, idx = topk_select.grouped_exact_top_k(_t(x), k, m=m)
    assert topk_select.FALLBACKS["exact_top_k"] - before == int(must_fail)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("engine", ["rank_topk", "random_rank_topk"])
def test_serving_counts_the_batches_sorted_again(engine: str, adversarial: bool) -> None:
    """Each serving batch whose certificate fails is sorted again exactly and
    counted in ``FALLBACKS`` under its engine; the output is the exact one."""
    n_subjects, n_objects, k, batch = 10, 1000, 20, 4
    expected_fallbacks = -(-n_subjects // batch) if adversarial else 0
    if engine == "rank_topk":
        objects = np.random.default_rng(2).normal(size=(n_objects, 4)).astype(np.float32)
        if adversarial:  # scores fall along the catalog: group 0 holds the whole top k
            objects[:, 0], objects[:, 1:] = np.linspace(100.0, 1.0, n_objects), 0.0
        subjects = np.ones((n_subjects, 4), np.float32)
        run = lambda: topk.rank_topk(subjects, objects, np.arange(n_subjects), k, batch_size=batch, device="cpu")
        expected = np.argsort(-(subjects @ objects.T), axis=1, kind="stable")[:, :k].ravel()
    else:
        blocks = {}
        rng = np.random.default_rng(3)

        def draw(bi: int, shape: tp.Tuple[int, int]) -> torch.Tensor:
            if bi not in blocks:
                row = np.linspace(1.0, 0.0, shape[1], dtype=np.float32) if adversarial else rng.random(shape[1])
                blocks[bi] = np.repeat(row[None, :].astype(np.float32), shape[0], axis=0)
            return torch.from_numpy(blocks[bi].copy())

        run = lambda: topk.random_rank_topk(draw, n_objects, np.arange(n_subjects), k, batch_size=batch,
                                            device="cpu")
        expected = None
    before = topk_select.FALLBACKS[engine]
    _, items, _ = run()
    assert topk_select.FALLBACKS[engine] - before == expected_fallbacks
    if expected is not None:
        np.testing.assert_array_equal(items, expected)
    elif adversarial:  # the drawn scores fall along the catalog: the first k objects, in order
        np.testing.assert_array_equal(items.reshape(n_subjects, k), np.tile(np.arange(k), (n_subjects, 1)))


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
