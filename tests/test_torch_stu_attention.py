"""The port's STU attention against the JAX package on the CPU, and its CUDA
kernels against their plain twins on the card.

Inputs come from a seed through numpy and go to both sides. The JAX side runs
its plain ``_stu_reference`` and its Pallas kernels in interpret mode, as
``tests/ops/test_stu_attention.py`` does. Tolerances: 1e-5 absolute on the
forward, 1e-4 absolute on the gradients of q, k, v and of the two tables
(sums over up to 96 keys, 2 heads and 2 rows in another order). The kernels
themselves are held against the twins on the card in
``tests/test_torch_kernels.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectools_tpu.ops.stu_attention import _bucket, _stu_pallas, _stu_pallas_bwd, _stu_reference, _toeplitz_bias
from rectools_tpu.ops.stu_attention import stu_attention as jax_stu_attention
from rectools_tpu_torch.ops import stu_attention

NB = 128
COMBOS = [(True, True), (True, False), (False, True), (False, False)]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(b=2, h=2, l=64, ad=16, lh=16, seed=0):
    """The arrays of tests/ops/test_stu_attention.py::_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, l, ad)).astype(np.float32)
    k = rng.normal(size=(b, h, l, ad)).astype(np.float32)
    v = rng.normal(size=(b, h, l, lh)).astype(np.float32)
    ts = 1_600_000_000 + np.sort(rng.integers(0, 86400 * 30, size=(b, l + 2)), axis=1).astype(np.int32)
    tl = (rng.random((b, l)) > 0.2).astype(np.float32)
    tw = rng.normal(size=(NB + 1,)).astype(np.float32) * 0.1
    pw = rng.normal(size=(2 * l - 1,)).astype(np.float32) * 0.1
    allowed = np.tril(np.ones((l, l), np.float32))[None]
    return q, k, v, ts, tl, tw, pw, allowed


def _port_out(q, k, v, ts, tl, tw, pw, allowed, use_time, use_pos):
    """The port's op in its (B, L, H, d) layout -> (B, H, L, lh)."""
    out = stu_attention.stu_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), ts, tl, allowed,
        tw if use_time else None, pw if use_pos else None, NB,
    )
    return out.transpose(1, 2)


def _port_loss_grads(arrays, use_time, use_pos):
    q, k, v, ts, tl, tw, pw, allowed = (_t(a) for a in arrays)
    leaves = [t.requires_grad_() for t in (q, k, v, tw, pw)]
    (_port_out(q, k, v, ts, tl, tw, pw, allowed, use_time, use_pos) ** 2).sum().backward()
    return [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]


def _jax_loss_grads(arrays, use_time, use_pos, block_q):
    q, k, v, ts, tl, tw, pw, allowed = (jnp.asarray(a) for a in arrays)

    def loss_ref(q, k, v, tw, pw):
        return jnp.sum(_stu_reference(q, k, v, ts, tl, tw, pw, allowed[0], NB, use_time, use_pos) ** 2)

    def loss_fused(q, k, v, tw, pw):
        return jnp.sum(jax_stu_attention(q, k, v, ts, tl, allowed, tw, pw, NB, use_time, use_pos, block_q, True) ** 2)

    return [jax.grad(f, argnums=(0, 1, 2, 3, 4))(q, k, v, tw, pw) for f in (loss_ref, loss_fused)]


@pytest.mark.parametrize("l,block_q", [(64, 64), (80, 32), (96, 32)])
@pytest.mark.parametrize("use_time,use_pos", COMBOS)
def test_forward_matches_jax(use_time: bool, use_pos: bool, l: int, block_q: int) -> None:
    arrays = _inputs(l=l)
    q, k, v, ts, tl, tw, pw, allowed = (jnp.asarray(a) for a in arrays)
    ref = _stu_reference(q, k, v, ts, tl, tw, pw, allowed[0], NB, use_time, use_pos)
    fused = jax_stu_attention(q, k, v, ts, tl, allowed, tw, pw, NB, use_time, use_pos, block_q, True)
    got = _port_out(*(_t(a) for a in arrays), use_time, use_pos).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(fused), atol=1e-5, rtol=0)


@pytest.mark.parametrize("l,ad,lh,block_q", [(100, 64, 64, 32), (100, 32, 32, 64), (70, 64, 32, 32)])
def test_forward_twin_matches_jax_pallas_at_the_tensor_core_dims(l: int, ad: int, lh: int, block_q: int) -> None:
    """The forward's twin, which the card's tensor-core forward is held to, at
    the head dims that take the tensor cores, against the JAX forward kernel
    ``_stu_pallas`` in interpret mode with a per-batch bias (time buckets plus
    positions, (B, L, L)), left padding and a fully padded row: 1e-5
    absolute, as the module states; the padded row gives zeros on both."""
    q, k, v, ts, tl, tw, pw, allowed = _inputs(b=3, l=l, ad=ad, lh=lh, seed=l + ad + lh)
    tl = (np.arange(l)[None, :] >= np.asarray([0, l // 3, l])[:, None]).astype(np.float32)
    expected = jax.jit(lambda *a: _stu_pallas(*a, NB, True, True, block_q, True))(
        *(jnp.asarray(a) for a in (q, k, v, ts, tl, tw, pw, allowed)))
    bias = stu_attention.combined_bias(stu_attention.time_buckets(_t(ts), l, NB), _t(tw), _t(pw), l,
                                       torch.device("cpu"))
    assert bias.shape == (3, l, l) and stu_attention.bwd_on_tensor_cores(ad, lh)
    got = stu_attention.stu_fwd(_t(q), _t(k), _t(v), bias, _t(allowed), _t(tl))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5, rtol=0)
    assert not got[-1].any() and not np.asarray(expected)[-1].any()


@pytest.mark.parametrize("l,block_q", [(64, 32), (80, 32)])
@pytest.mark.parametrize("use_time,use_pos", COMBOS)
def test_gradients_match_jax(use_time: bool, use_pos: bool, l: int, block_q: int) -> None:
    arrays = _inputs(l=l)
    got = _port_loss_grads(arrays, use_time, use_pos)
    for expected in _jax_loss_grads(arrays, use_time, use_pos, block_q):
        for name, g, e in zip("q k v tw pw".split(), got, expected):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4, rtol=0, err_msg=name)
    if use_time:
        assert got[3].abs().max() > 0
        assert not got[3][len(stu_attention.bucket_thresholds()) + 1 :].any()  # buckets no int32 difference reaches
    if use_pos:
        assert got[4].abs().max() > 0


@pytest.mark.parametrize("l,ad,lh,block_q", [(80, 32, 32, 32), (96, 64, 32, 32), (100, 16, 16, 64), (7, 32, 64, 8)])
def test_backward_twin_matches_jax_pallas_bwd(l: int, ad: int, lh: int, block_q: int) -> None:
    """The backward kernel's twin (dq, dk, dv), which the card's two launches
    are held to (dk and dv per key tile, dq per query tile, no partials),
    against the JAX backward kernel ``_stu_pallas_bwd`` in interpret mode, time
    and position bias on, at ragged lengths and at both routes' head dims:
    1e-4 absolute, as the module states."""
    q, k, v, ts, tl, tw, pw, allowed = _inputs(l=l, ad=ad, lh=lh, seed=l + ad)
    d_out = np.random.default_rng(l).normal(size=v.shape).astype(np.float32)
    jax_bwd = jax.jit(lambda *a: _stu_pallas_bwd(*a, NB, True, True, block_q, True)[:3])
    expected = jax_bwd(*(jnp.asarray(a) for a in (q, k, v, ts, tl, tw, pw, allowed, d_out)))
    bias = stu_attention.combined_bias(stu_attention.time_buckets(_t(ts), l, NB), _t(tw), _t(pw), l,
                                       torch.device("cpu"))
    got = stu_attention.stu_bwd(_t(q), _t(k), _t(v), bias, _t(allowed), _t(tl), _t(d_out))
    assert stu_attention.bwd_on_tensor_cores(ad, lh) == (ad >= 32 and lh >= 32)
    for name, g, e in zip(("dq", "dk", "dv"), got, expected):
        assert np.abs(np.asarray(e)).max() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4, rtol=0, err_msg=name)


def test_second_precision_timestamps() -> None:
    """1-second differences at unix-epoch size land in their own buckets:
    the differences are taken in integers (f32 timestamps would collapse them)."""
    q, k, v, _, tl, tw, pw, allowed = _inputs(b=1, l=32)
    ts = (1_700_000_000 + np.arange(34, dtype=np.int32))[None, :]
    ref = _stu_reference(*(jnp.asarray(a) for a in (q, k, v, ts, tl, tw, pw)), jnp.asarray(allowed[0]), NB, True, False)
    got = _port_out(*(_t(a) for a in (q, k, v, ts, tl, tw, pw, allowed)), True, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # int64 timestamps, as the data preparator hands them, give the same buckets
    got64 = _port_out(*(_t(a) for a in (q, k, v, ts.astype(np.int64), tl, tw, pw, allowed)), True, False)
    assert torch.equal(got, got64)
    buckets = stu_attention.time_buckets(_t(ts), 32, NB)
    assert buckets[0, 0, 0] == 0 and buckets[0, 1, 0] == 2 and len(torch.unique(buckets)) > 8


def test_buckets_equal_jax() -> None:
    """Integer buckets against JAX's float formula: equal to jitted and eager
    JAX on every difference these tests use, on every |Δt| below 300,000 s and
    on both signs. Above, jitted and eager JAX themselves differ at integers
    next to a boundary (the first is 309,279). The port's thresholds are those
    of a correctly rounded float32 logarithm; over every |Δt| below 3,000,000 s
    and the neighbourhood of every boundary up to 2^31 they equal jitted JAX's
    except at three float32 values beyond 132 days, by one bucket, and nowhere
    else."""
    thresholds = stu_attention.bucket_thresholds()
    assert len(thresholds) == 71 and thresholds[0] == 2 and list(thresholds) == sorted(thresholds)
    jax_bucket = jax.jit(lambda d: _bucket(d, NB))

    used = [np.arange(-300_000, 300_000, dtype=np.int32)]
    for l in (32, 64, 80, 96):
        ts = _inputs(l=l)[3]
        used.append((ts[:, 1 : l + 1, None] - ts[:, None, :l]).ravel())
    used = np.concatenate(used)
    got = stu_attention.bucket(_t(used), NB).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_bucket(jnp.asarray(used))))
    np.testing.assert_array_equal(got, np.asarray(_bucket(jnp.asarray(used), NB)))  # eager JAX too

    wide = [np.arange(300_000, 3_000_000, dtype=np.int64)]
    for c in thresholds:
        w = max(64, int(c * 2e-5))
        wide.append(np.arange(max(1, c - w), min(2**31 - 1, c + w), dtype=np.int64))
    wide.append(np.asarray([2**31 - 1, -(2**31)], dtype=np.int64))
    wide = np.unique(np.concatenate(wide)).astype(np.int32)
    got = stu_attention.bucket(_t(wide), NB).numpy().astype(np.int64)
    expected = np.asarray(jax_bucket(jnp.asarray(wide))).astype(np.int64)
    # the integers that round to the float32 values 11,455,709, 51,598,328 and 94,206,440
    known = {11_455_709, *range(51_598_326, 51_598_331), *range(94_206_437, 94_206_444)}
    assert set(wide[got != expected].tolist()) <= known
    assert np.abs(got - expected).max() <= 1
    assert got.max() == 71 and stu_attention.bucket(_t(wide), 50).max() == 50  # the clip to num_buckets


def test_toeplitz_bias_equals_jax() -> None:
    pw = np.random.default_rng(4).normal(size=(2 * 24 - 1,)).astype(np.float32)
    for l in (24, 17):  # a table longer than 2L - 1 is cut, as in JAX
        np.testing.assert_array_equal(
            stu_attention.toeplitz_bias(_t(pw), l).numpy(), np.asarray(_toeplitz_bias(jnp.asarray(pw), l))
        )


def test_batch_dependent_allowed_matches_dense_math() -> None:
    """A key-padding mask makes ``allowed`` (B, L, L): the twins and the table
    gradients against autograd of the materialized form."""
    q, k, v, ts, tl, tw, pw, _ = (_t(a) for a in _inputs(l=48, seed=3))
    b, _, l, _ = q.shape
    rng = np.random.default_rng(5)
    allowed = _t((np.tril(np.ones((l, l), np.float32))[None] * (rng.random((b, 1, l)) > 0.3)).astype(np.float32))
    leaves = [t.requires_grad_() for t in (q, k, v, tw, pw)]

    def dense(q, k, v, tw, pw):
        bias = tw[stu_attention.time_buckets(ts, l, NB).long()] + stu_attention.toeplitz_bias(pw, l)[None]
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
        a = torch.nn.functional.silu(s) / l * (allowed * tl[:, :, None] * tl[:, None, :])[:, None]
        return torch.einsum("bhqk,bhkd->bhqd", a, v)

    expected_out = dense(*leaves)
    expected = torch.autograd.grad((expected_out**2).sum(), leaves)
    out = _port_out(q, k, v, ts, tl, tw, pw, allowed, True, True)
    got = torch.autograd.grad((out**2).sum(), leaves)
    torch.testing.assert_close(out, expected_out, atol=1e-5, rtol=0)
    for g, e in zip(got, expected):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=0)


@pytest.mark.parametrize("l,ad,lh", [(64, 16, 16), (100, 32, 32), (90, 64, 64), (70, 32, 64)])
def test_score_gradient_sums_by_bucket(l: int, ad: int, lh: int) -> None:
    """``stu_ds`` gives ds and, with the buckets, its sums by bucket, per block
    of the kernel's tile for these head dims (128 keys x 32 queries on the
    SIMT kernel, 64 x 64 on the tensor cores) and then over the blocks: against
    a float64 scatter-add of the same ds (1e-5: f32 sums of up to 100 x 100 x 2
    entries), and None without buckets."""
    q, k, v, ts, tl, tw, pw, allowed = (_t(a) for a in _inputs(l=l, ad=ad, lh=lh))
    dout = _t(np.random.default_rng(6).normal(size=tuple(v.shape)).astype(np.float32))
    buckets = stu_attention.time_buckets(ts, l, NB)
    bias = stu_attention.combined_bias(buckets, tw, pw, l, q.device)
    ds, sums = stu_attention.stu_ds(q, k, v, bias, allowed, tl, dout, buckets, NB + 1)
    alone, none = stu_attention.stu_ds(q, k, v, bias, allowed, tl, dout)
    assert none is None and torch.equal(alone, ds) and tuple(sums.shape) == (NB + 1,)
    expected = torch.zeros(NB + 1, dtype=torch.float64).index_add_(0, buckets.reshape(-1), ds.reshape(-1).double())
    torch.testing.assert_close(sums.double(), expected, atol=1e-5, rtol=0)
    assert sums.abs().max() > 0
    # the twin's order, written out: one partial per block of the tile, batch row, key tile, query tile
    keys, queries = stu_attention.ds_tile(ad, lh)
    assert (keys, queries) == ((64, 64) if ad >= 32 and lh >= 32 else (128, 32))
    partials = []
    for bi in range(ds.shape[0]):
        for k0 in range(0, l, keys):
            for q0 in range(0, l, queries):
                tile = (bi, slice(q0, q0 + queries), slice(k0, k0 + keys))
                partials.append(torch.stack([ds[tile][buckets[tile] == j].sum() for j in range(NB + 1)]))
    torch.testing.assert_close(sums, torch.stack(partials).sum(dim=0), atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "l,ad,lh,mask,block_q", [(100, 32, 32, "causal", 32), (90, 64, 64, "causal", 32), (100, 64, 32, "key_padding", 64),
                             (90, 32, 32, "key_padding", 32)]
)
def test_score_gradient_twin_matches_jax_pallas_bwd(l: int, ad: int, lh: int, mask: str, block_q: int) -> None:
    """The score-gradient kernel's twin (ds summed over heads, its sums by time
    bucket per block of the card's 64 x 64 tile, then over the blocks), from
    which the two tables get their gradients, against the JAX ``_stu_pallas_bwd``
    in interpret mode (its ``_stu_ds_kernel``): ``dtw`` and ``dpw``, at L = 100
    and at a length that is not a multiple of 64, heads of 32 and 64, under the
    causal mask and a key-padding one (shared by the batch, as the JAX kernel
    takes it); 1e-4 absolute, as the module states."""
    q, k, v, ts, tl, tw, pw, allowed = _inputs(l=l, ad=ad, lh=lh, seed=l + ad + lh)
    if mask == "key_padding":  # the first 23 keys are padding, the diagonal stays
        allowed = np.maximum(allowed * (np.arange(l) >= 23)[None, None, :], np.eye(l, dtype=np.float32)[None])
        allowed = allowed.astype(np.float32)
    d_out = np.random.default_rng(l + 1).normal(size=v.shape).astype(np.float32)
    jax_bwd = jax.jit(lambda *a: _stu_pallas_bwd(*a, NB, True, True, block_q, True)[3:])
    expected = jax_bwd(*(jnp.asarray(a) for a in (q, k, v, ts, tl, tw, pw, allowed, d_out)))
    buckets = stu_attention.time_buckets(_t(ts), l, NB)
    bias = stu_attention.combined_bias(buckets, _t(tw), _t(pw), l, torch.device("cpu"))
    ds, dtw = stu_attention.stu_ds_reference(_t(q), _t(k), _t(v), bias, _t(allowed), _t(tl), _t(d_out), buckets,
                                             NB + 1)
    pw_leaf = _t(pw).requires_grad_()
    (dpw,) = torch.autograd.grad(stu_attention.toeplitz_bias(pw_leaf, l), pw_leaf, ds.sum(dim=0))
    assert stu_attention.ds_tile(ad, lh) == (64, 64)
    for name, g, e in zip(("dtw", "dpw"), (dtw, dpw), expected):
        assert np.abs(np.asarray(e)).max() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4, rtol=0, err_msg=name)


def test_fully_padded_rows_give_zeros_and_no_nan() -> None:
    q, k, v, ts, tl, tw, pw, allowed = (_t(a) for a in _inputs(l=32))
    tl[0] = 0.0  # a whole session of padding
    tl[1, :20] = 0.0  # left padding, as the recommend path has
    q.requires_grad_()
    out = _port_out(q, k, v, ts, tl, tw, pw, allowed, True, True)
    assert torch.isfinite(out).all() and not out[0].any() and not out[1, :, :20].any()
    out.sum().backward()
    assert torch.isfinite(q.grad).all() and not q.grad[0].any()


def test_wrappers_refuse_what_the_kernels_do_not_take() -> None:
    q, k, v, ts, tl, tw, pw, allowed = (_t(a) for a in _inputs(l=16))
    with pytest.raises(ValueError, match="come together"):
        stu_attention.stu_attention(q, k, v, None, tl, allowed, tw, pw)
    with pytest.raises(ValueError, match="needs timestamps"):
        stu_attention.stu_dot_product_attention(q, k, v, None, tl, allowed, tw, pw, NB)
    with pytest.raises(TypeError, match="int32"):
        stu_attention.bucket(ts.long(), NB)
    bias = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):  # the kernel path never takes a CPU tensor quietly
        stu_attention._check("stu_fwd", q, k, v, bias, allowed, tl)
