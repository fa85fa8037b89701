"""The port's training kernels and losses, held against the JAX package on the CPU.

Every input is made from a seed with numpy and fed to both sides. The port
runs on CPU tensors, i.e. through each kernel's plain PyTorch twin and its
``autograd.Function``; the JAX side runs its Pallas kernels in interpret mode
(or, for the losses, its XLA path). The CUDA kernels themselves are held
against the twins on the card by tests/test_torch_kernels.py and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectools_tpu.models.nn import dropout as jax_dropout
from rectools_tpu.models.nn.transformers import losses as jax_losses
from rectools_tpu.ops import attention as jax_attention
from rectools_tpu.ops import layer_norm as jax_layer_norm
from rectools_tpu.ops import softmax_lse as jax_softmax_lse
from rectools_tpu_torch.models.nn import dropout
from rectools_tpu_torch.models.nn.transformers import losses
from rectools_tpu_torch.ops import attention, layer_norm, softmax_lse, stu_attention

MASK_VALUE = -1e9


def _t(x: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _causal_bias(l: int) -> np.ndarray:
    return np.where(np.tril(np.ones((l, l), dtype=bool)), 0.0, MASK_VALUE).astype(np.float32)[None, None]


# ------------------------------------------------------------------ counter-hash dropout


@pytest.mark.parametrize("key_seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_hash_keep_mask_bits_equal_jax(key_seed: int, rate: float) -> None:
    key = jax.random.PRNGKey(key_seed)
    words = [int(w) for w in np.asarray(jax_dropout._key_words(key))]
    shape = (3, 20, 33)
    expected = np.asarray(jax_dropout.hash_keep_mask(key, shape, rate))
    got = dropout.hash_keep_mask(words, shape, rate).numpy()
    np.testing.assert_array_equal(got, expected)
    assert abs(got.mean() - (1 - rate)) < 0.05


@pytest.mark.parametrize("key_seed", [1, 12345])
@pytest.mark.parametrize("low,high", [(1, 301), (1, 15872)])
def test_hash_uniform_ints_equal_jax(key_seed: int, low: int, high: int) -> None:
    key = jax.random.PRNGKey(key_seed)
    words = [int(w) for w in np.asarray(jax_dropout._key_words(key))]
    shape = (4, 20, 7)
    expected = np.asarray(jax_dropout.hash_uniform_ints(key, shape, low, high))
    got = dropout.hash_uniform_ints(words, shape, low, high).numpy()
    np.testing.assert_array_equal(got, expected)
    assert got.min() >= low and got.max() < high


def test_hash_dropout_module_applies_the_mask_of_its_drawn_words() -> None:
    x = torch.ones((2, 5, 16))
    module = torch.nn.Sequential(dropout.HashDropout(0.25)).train()
    with pytest.raises(RuntimeError, match="generator"):
        module(x)
    dropout.attach_generator(module, torch.Generator().manual_seed(3))
    out = module(x)
    words = dropout.draw_key_words(torch.Generator().manual_seed(3))
    keep = dropout.hash_keep_mask(words, x.shape, 0.25)
    torch.testing.assert_close(out, torch.where(keep, x / 0.75, torch.zeros_like(x)))
    assert torch.equal(module.eval()(x), x)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_attention_keep_mask_bits_equal_jax(seed: int, rate: float) -> None:
    b, h, l = 3, 2, 37
    expected = np.asarray(jax_attention._full_keep_mask(jnp.array([seed], jnp.int32), b * h, l, rate))
    got = attention.dropout_keep_mask(seed, b, h, l, rate).numpy().reshape(b * h, l, l)
    np.testing.assert_array_equal(got, expected)


# ------------------------------------------------------------------ LayerNorm backward


@pytest.mark.parametrize("m", [37, 1030])
@pytest.mark.parametrize("eps", [1e-6, 1e-8])
def test_layer_norm_backward_matches_jax(m: int, eps: float) -> None:
    rng = np.random.default_rng(m)
    d = 64
    x = (rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)
    gamma = rng.normal(size=(d,)).astype(np.float32)
    beta = rng.normal(size=(d,)).astype(np.float32)
    dy = rng.normal(size=(m, d)).astype(np.float32)
    y_jax, vjp = jax.vjp(
        lambda a, g, b: jax_layer_norm.fused_layer_norm(a, g, b, eps, 1024, True), *map(jnp.asarray, (x, gamma, beta))
    )
    expected = vjp(jnp.asarray(dy))

    xt, gt, bt = _t(x, True), _t(gamma, True), _t(beta, True)
    y = layer_norm.layer_norm(xt, gt, bt, eps)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), atol=1e-5, rtol=1e-5)
    for got, exp in zip((xt.grad, gt.grad, bt.grad), expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)
    twin = layer_norm.layer_norm_bwd_reference(_t(x), _t(gamma), _t(dy), eps)
    for got, exp in zip(twin, expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


def _ln_bwd_sums_in_the_partition_order(x: np.ndarray, dy: np.ndarray, eps: float) -> tuple:
    """Kernel 4's dγ and dβ in the order of its partition, in float32: block b
    of ``bwd_partition`` owns rows [b · rows, (b + 1) · rows); warp w of a
    block (16 warps for d <= 256, else 8: ``bwd_warps`` in the ``.cu``) adds
    its rows w, w + warps, ... one after another; the block adds its warps'
    sums in warp order into its partial row; the last block sums the partial
    rows of blocks [g · per, (g + 1) · per) per group g (one group a warp, per
    = ceil(blocks / warps)), then the groups in order. The row statistics are
    numpy's, not the card's (its warp trees and ``rsqrtf`` are not modelled),
    so the terms differ from the card's in their last bits."""
    m, d = x.shape
    mu = x.mean(axis=1, keepdims=True, dtype=np.float32)
    xc = x - mu
    rstd = (1.0 / np.sqrt((xc * xc).mean(axis=1, keepdims=True, dtype=np.float32) + np.float32(eps))).astype(np.float32)
    terms = np.stack([dy * (xc * rstd), dy], axis=1).astype(np.float32)  # (m, 2, d)
    n_blocks, rows = layer_norm.bwd_partition(m)
    warps = 16 if d <= 256 else 8
    partials, seen = [], 0
    for b in range(n_blocks):
        r0, r1 = b * rows, min(m, (b + 1) * rows)
        block = np.zeros((2, d), np.float32)
        for w in range(warps):
            acc = np.zeros((2, d), np.float32)
            for r in range(r0 + w, r1, warps):
                acc = acc + terms[r]
                seen += 1
            block = block + acc
        partials.append(block)
    assert seen == m  # every row once
    per = -(-n_blocks // warps)
    total = np.zeros((2, d), np.float32)
    for g in range(warps):
        acc = np.zeros((2, d), np.float32)
        for b in range(g * per, min(n_blocks, (g + 1) * per)):
            acc = acc + partials[b]
        total = total + acc
    return total[0], total[1]


@pytest.mark.parametrize("m", [37, 1030, 8193])
def test_layer_norm_bwd_partition_sums_match_jax(m: int) -> None:
    """Kernel 4's partition of the dγ/dβ sums (per-block partials over the
    rows of ``bwd_partition``, summed by the last block in groups), modelled
    in float32, against the JAX ``fused_layer_norm`` VJP in interpret mode:
    within 1e-5 of the largest entry (``LN_BWD_TOL`` of chip_smoke.py: sums
    over thousands of rows). A tolerance check of the partition, which covers
    every row once; it does not pin the card's bits, which the GPU tests hold
    against the twin. 8,193 rows leave a last block of 65 rows where the
    others hold 127."""
    rng = np.random.default_rng(m + 5)
    d, eps = 128, 1e-6
    x = (rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)
    gamma = rng.normal(size=(d,)).astype(np.float32)
    beta = rng.normal(size=(d,)).astype(np.float32)
    dy = rng.normal(size=(m, d)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, g, b: jax_layer_norm.fused_layer_norm(a, g, b, eps, 1024, True), *map(jnp.asarray, (x, gamma, beta))
    )
    _, dgamma, dbeta = vjp(jnp.asarray(dy))
    if m == 8193:
        assert layer_norm.bwd_partition(m) == (65, 127)
    for got, exp in zip(_ln_bwd_sums_in_the_partition_order(x, dy, eps), (dgamma, dbeta)):
        exp = np.asarray(exp)
        assert np.abs(got - exp).max() <= 1e-5 * np.abs(exp).max()


# ------------------------------------------------------------------ attention forward and backward


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("bias_kind", ["causal", "none"])
def test_attention_forward_backward_matches_jax(rate: float, bias_kind: str) -> None:
    rng = np.random.default_rng(21)
    b, h, l, dh, seed = 2, 2, 20, 16, 98765
    q, k, v, dout = (rng.normal(size=(b, h, l, dh)).astype(np.float32) for _ in range(4))
    bias = _causal_bias(l) if bias_kind == "causal" else np.zeros((1, 1, l, l), np.float32)
    scale = 1.0 / np.sqrt(dh)

    def jax_fn(jq, jk, jv):
        return jax_attention.fused_attention(
            jq, jk, jv, jnp.asarray(bias), jnp.array([seed], jnp.int32), scale, rate, 8, True, False
        )

    out_jax, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    dq_jax, dk_jax, dv_jax = vjp(jnp.asarray(dout))

    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    port_bias = None if bias_kind == "none" else _t(bias)
    out = attention.attention(qt, kt, vt, port_bias, scale, rate, seed)
    out.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_jax), atol=1e-5, rtol=1e-5)
    for got, exp in ((qt.grad, dq_jax), (kt.grad, dk_jax), (vt.grad, dv_jax)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


def test_attention_refuses_a_learnable_bias() -> None:
    q = _t(np.zeros((1, 1, 4, 8), np.float32), True)
    with pytest.raises(NotImplementedError, match="constant mask"):
        attention.attention(q, q, q, _t(np.zeros((1, 1, 4, 4), np.float32), True), 1.0)


# ------------------------------------------------------------------ streaming lse and CE gradients


def _lse_inputs(m: int, n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    s = (0.5 * rng.normal(size=(m, d))).astype(np.float32)
    items = (0.5 * rng.normal(size=(n, d))).astype(np.float32)
    return rng, s, items


@pytest.mark.parametrize("m,n", [(50, 300), (64, 129)])  # ragged against block_m = 16 and chunk_n = 64
def test_streaming_lse_matches_jax(m: int, n: int) -> None:
    _, s, items = _lse_inputs(m, n, 32, seed=m + n)
    expected = np.asarray(jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True))
    got = softmax_lse.streaming_lse(_t(s), _t(items)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=1e-5)
    # the twin's chunking is its own: any chunk gives the same lse
    small = softmax_lse.streaming_lse_reference(_t(s), _t(items), chunk=7).numpy()
    np.testing.assert_allclose(small, expected, atol=1e-5, rtol=1e-5)


def test_streaming_lse_refuses_unported_routes() -> None:
    """No route of the JAX ``streaming_lse`` is refused any more: a row bias
    (kernel 8) and ``bounded_shift`` (kernel 16) both run."""
    s = _t(np.zeros((4, 16), np.float32))
    plain = softmax_lse.streaming_lse(s, s).numpy()
    # an all-zero bias changes nothing
    np.testing.assert_array_equal(softmax_lse.streaming_lse(s, s, row_bias=_t(np.zeros(4, np.float32))).numpy(), plain)
    # zero rows: shift 0, every logit 0, window 1 holds log 4
    np.testing.assert_allclose(softmax_lse.streaming_lse(s, s, bounded_shift=True).numpy(), plain, rtol=1e-6)
    np.testing.assert_allclose(plain, np.full(4, np.log(4.0), np.float32), rtol=1e-6)


def _jump_case(kind: str):
    """The forward cases of tests/ops/test_softmax_lse.py:80-106: a logit ~400
    above every earlier chunk's max in the last chunk ("up"), or later chunks
    far below the first one's max ("down")."""
    if kind == "up":
        rng = np.random.default_rng(3)
        s = rng.normal(size=(8, 32)).astype(np.float32)
        items = rng.normal(scale=0.1, size=(256, 32)).astype(np.float32)
        items[200] = 400.0 * s[0] / np.linalg.norm(s[0]) ** 2
        return s, items.astype(np.float32)
    rng = np.random.default_rng(5)
    s = rng.normal(size=(4, 16)).astype(np.float32)
    items = np.concatenate([rng.normal(scale=3.0, size=(64, 16)), rng.normal(scale=0.001, size=(192, 16))])
    return s, items.astype(np.float32)


@pytest.mark.parametrize("partials", [True, False])
@pytest.mark.parametrize("case", ["50x300", "64x129", "up", "down"])
def test_lse_forward_kernels_match_jax(monkeypatch, case: str, partials: bool) -> None:
    """Kernel 6's twin (per-chunk partials, combined) with ``USE_PARTIALS_FWD``
    and kernel 15's (one running max) without, against the JAX forward with
    ``_USE_PARTIALS_FWD`` set alike, in interpret mode: 1e-5 relative."""
    if case in ("up", "down"):
        s, items = _jump_case(case)
    else:
        m, n = map(int, case.split("x"))
        _, s, items = _lse_inputs(m, n, 32, seed=m * n)
    monkeypatch.setattr(jax_softmax_lse, "_USE_PARTIALS_FWD", partials)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", partials)
    expected = np.asarray(jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True))
    got = softmax_lse.streaming_lse(_t(s), _t(items)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expected, rtol=1e-5)
    twin = softmax_lse.streaming_lse_partials_reference if partials else softmax_lse.streaming_lse_reference
    np.testing.assert_allclose(twin(_t(s), _t(items), chunk=64).numpy(), expected, rtol=1e-5)
    if case == "up":  # the jump lands in the last of four chunks
        assert got[0] > 399.0


def test_lse_partials_combine_is_the_jax_formula() -> None:
    """The twin's partials are each chunk's (max, Σexp) and the combine is
    rectools_tpu/ops/softmax_lse.py:411-413."""
    _, s, items = _lse_inputs(9, 130, 16, seed=1)
    logits = _t(s) @ _t(items).T
    chunks = [logits[:, i : i + 64] for i in range(0, 130, 64)]  # 64, 64, 2 columns
    m_part = torch.stack([c.max(dim=1).values for c in chunks])
    l_part = torch.stack([torch.exp(c - c.max(dim=1, keepdim=True).values).sum(dim=1) for c in chunks])
    m_all = m_part.max(dim=0).values
    expected = m_all + torch.log((l_part * torch.exp(m_part - m_all)).sum(dim=0))
    torch.testing.assert_close(softmax_lse.combine_lse_partials(m_part, l_part), expected, rtol=0, atol=0)
    torch.testing.assert_close(softmax_lse.streaming_lse_partials_reference(_t(s), _t(items), chunk=64), expected,
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,n,d", [(40, 4300, 32), (33, 4200, 64), (20, 4500, 128), (17, 4300, 16)])
def test_lse_partials_twin_in_the_cards_chunks_matches_jax(m: int, n: int, d: int) -> None:
    """Kernel 6's twin walks the catalog in the card's chunks (``LSE_CHUNK``
    rows, on the tensor-core tile and on the SIMT tile alike: three chunks, a
    ragged last one, at these shapes), and so does the CPU ``streaming_lse``;
    both hold against the JAX forward ``_streaming_lse_fwd`` with per-chunk
    partials in interpret mode at ragged M and N, 1e-5 relative per row."""
    _, s, items = _lse_inputs(m, n, d, seed=m + n + d)
    assert -(-n // softmax_lse.LSE_CHUNK) == 3
    lse, _ = jax_softmax_lse._streaming_lse_fwd(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True, False)
    expected = np.asarray(lse)
    twin = softmax_lse.streaming_lse_partials_reference(_t(s), _t(items))
    m_parts, l_parts = [], []
    for start in range(0, n, softmax_lse.LSE_CHUNK):  # the chunks, written out
        logits = _t(s) @ _t(items[start : start + softmax_lse.LSE_CHUNK]).T
        m_parts.append(logits.max(dim=1).values)
        l_parts.append(torch.exp(logits - m_parts[-1][:, None]).sum(dim=1))
    chunked = softmax_lse.combine_lse_partials(torch.stack(m_parts), torch.stack(l_parts))
    torch.testing.assert_close(twin, chunked, rtol=0, atol=0)
    torch.testing.assert_close(softmax_lse.streaming_lse(_t(s), _t(items)), twin, rtol=0, atol=0)
    np.testing.assert_allclose(twin.numpy(), expected, rtol=1e-5)


def _z_case(m: int, n: int, seed: int):
    rng, s, items = _lse_inputs(m, n, 32, seed=seed)
    coeff = rng.uniform(0.0, 0.05, size=m).astype(np.float32)
    coeff[::5] = 0.0  # ignored rows: z = +inf
    lse = np.asarray(jax_softmax_lse.reference_lse(jnp.asarray(s), jnp.asarray(items)))
    with np.errstate(divide="ignore"):
        z = (lse - np.log(coeff)).astype(np.float32)
    return rng, s, items, z, coeff


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("m,n", [(50, 300), (64, 129), (33, 70)])  # ragged against block_m = 16 and chunk_n = 64
def test_softmax_grads_from_z_matches_jax(monkeypatch, m: int, n: int, route: str) -> None:
    """Kernel 12's twin (one ds partial per chunk) or, with the budget forced
    to 0 on both sides, kernels 13 + 14's (a running sum) against the JAX op in
    interpret mode, with z = +inf rows and a ragged tail; the tolerance of the
    CE gradients' test. z = +inf rows give exactly 0 in ds."""
    _, s, items, z, coeff = _z_case(m, n, seed=5 * m + n)
    if route == "split":
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
        monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)
    orders = []
    twin = softmax_lse.softmax_grads_from_z_reference
    monkeypatch.setattr(softmax_lse, "softmax_grads_from_z_reference",
                        lambda *a, **k: orders.append(k["partials"]) or twin(*a, **k))
    ds_jax, di_jax = jax_softmax_lse.softmax_grads_from_z(*map(jnp.asarray, (s, items, z)), 16, 64, True)
    ds, di = softmax_lse.softmax_grads_from_z(_t(s), _t(items), _t(z))
    assert orders == [route == "fused"]
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_jax), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(di.numpy(), np.asarray(di_jax), atol=1e-5, rtol=1e-5)
    assert not ds.numpy()[coeff == 0].any()
    # the twin's chunking is its own
    small = twin(_t(s), _t(items), _t(z), chunk=7, partials=route == "fused")
    for got, expected in zip(small, (ds_jax, di_jax)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,n", [(50, 300), (64, 129)])
def test_ce_split_route_matches_jax_fallback(monkeypatch, m: int, n: int) -> None:
    """With the partials budget lowered on both sides, the JAX CE op takes its
    very-large-catalog fallback (softmax_lse.py:748-754: the spy sees its
    ``softmax_grads_from_z``) and the port takes the same route: its
    ``softmax_grads_from_z`` in the split order (kernels 13 + 14, not 12), then
    the label term. Both agree, and equal the port's kernel-7 twin."""
    rng, s, items, z, coeff = _z_case(m, n, seed=11 * m + n)
    y = rng.integers(0, n, size=m).astype(np.int32)
    monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    calls = {"jax": 0, "port": 0, "orders": []}
    jax_gz, port_gz, twin = (jax_softmax_lse.softmax_grads_from_z, softmax_lse.softmax_grads_from_z,
                             softmax_lse.softmax_grads_from_z_reference)

    def jax_spy(*a, **k):
        calls["jax"] += 1
        return jax_gz(*a, **k)

    def port_spy(*a, **k):
        calls["port"] += 1
        return port_gz(*a, **k)

    monkeypatch.setattr(jax_softmax_lse, "softmax_grads_from_z", jax_spy)
    monkeypatch.setattr(softmax_lse, "softmax_grads_from_z", port_spy)
    monkeypatch.setattr(softmax_lse, "softmax_grads_from_z_reference",
                        lambda *a, **k: calls["orders"].append(k["partials"]) or twin(*a, **k))
    ds_jax, di_jax = jax_softmax_lse.softmax_ce_grads_from_z(*map(jnp.asarray, (s, items, z, y, coeff)), 16, 64, True)
    yt = _t(y.astype(np.int64))
    assert softmax_lse.ce_takes_split_route(m, n, 32)
    ds, di = softmax_lse.softmax_ce_grads_from_z(_t(s), _t(items), _t(z), yt, _t(coeff))
    assert calls == {"jax": 1, "port": 1, "orders": [False]}
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_jax), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(di.numpy(), np.asarray(di_jax), atol=1e-5, rtol=1e-5)
    kernel_7 = softmax_lse.softmax_ce_grads_from_z_reference(_t(s), _t(items), _t(z), yt, _t(coeff))
    for got, expected in zip((ds, di), kernel_7):
        np.testing.assert_allclose(got.numpy(), expected.numpy(), atol=1e-5 * expected.abs().max().item())
    again = softmax_lse.softmax_ce_grads_from_z(_t(s), _t(items), _t(z), yt, _t(coeff))
    assert all(torch.equal(a, g) for a, g in zip(again, (ds, di)))


def _jax_ce_takes_split_route(m: int, n: int, d: int) -> bool:
    """The decision as the JAX package makes it for an f32 fit: the tiling of
    ``fused_softmax_loss``, the caps of ``_fused_ce_bwd``, the bytes and the
    budget of ``softmax_ce_grads_from_z``."""
    if d <= 128:
        block_m, chunk_n = jax_losses._NARROW_D_TILING_F32
    else:
        block_m, chunk_n = jax_softmax_lse.DEFAULT_BLOCK_M, jax_softmax_lse.DEFAULT_CHUNK_N
    chunk_cap = max(1024, (4096 * 128 // max(d, 1)) // 1024 * 1024)
    block_m, chunk_n = min(block_m, 384), min(chunk_n, chunk_cap)
    padded_m = -(-m // block_m) * block_m
    return -(-n // chunk_n) * padded_m * d * 4 > jax_softmax_lse._FUSED_BWD_PARTIALS_BUDGET


@pytest.mark.parametrize(
    "m,n,d,split",
    [(51200, 81920, 128, False), (51200, 81921, 128, True), (51200, 15872, 128, False), (51200, 131072, 128, True),
     (51200, 20480, 256, False), (51200, 20481, 256, True), (640, 3000, 64, False), (52224, 81920, 128, False),
     (52225, 81920, 128, True)],
)
def test_ce_route_threshold_is_the_jax_rule(m: int, n: int, d: int, split: bool) -> None:
    """At the KION training width (512 x 100 rows, d = 128) 81,920 items stay
    on kernel 7 and 81,921 leave it; at d = 256, 20,480 and 20,481; at 81,920
    items, 52,225 rows pad to a 205th block of 256 and pass the budget where
    52,224 do not. The port's own plan puts
    the 131,072-item catalog over budget too: the route runs kernels 13 + 14."""
    assert softmax_lse.ce_takes_split_route(m, n, d) == _jax_ce_takes_split_route(m, n, d) == split
    if (m, n, d) == (51200, 131072, 128):
        assert softmax_lse.fused_bwd_plan(m, n, d, 132)[2] > softmax_lse.FUSED_BWD_PARTIALS_BUDGET


def _shift_case(scale: float, m: int = 60, n: int = 300, d: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    s = (scale * rng.normal(size=(m, d))).astype(np.float32)
    items = (scale * rng.normal(size=(n, d))).astype(np.float32)
    return s, items


def _bound_gap(s: np.ndarray, items: np.ndarray) -> np.ndarray:
    logits = s.astype(np.float64) @ items.astype(np.float64).T
    shift = np.linalg.norm(s.astype(np.float64), axis=1) * np.linalg.norm(items.astype(np.float64), axis=1).max()
    return shift - logits.max(axis=1)


@pytest.mark.parametrize("scale", [0.3, 1.0, 1.5])
def test_bounded_shift_matches_jax(scale: float) -> None:
    """Kernel 16's twin against the JAX fixed-shift kernel in interpret mode
    (tests/ops/test_softmax_lse.py:26-37: scales 1.0 and 1.5; 0.3 keeps every
    row in window 1, 1.5 sends every row to window 2): 1e-5 relative."""
    s, items = _shift_case(scale)
    expected = np.asarray(jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True, True))
    got = softmax_lse.streaming_lse(_t(s), _t(items), bounded_shift=True).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_softmax_lse.reference_lse(jnp.asarray(s), jnp.asarray(items))),
                               rtol=1e-5, atol=1e-6)
    shift, l, l2 = softmax_lse.lse_shift_sums_reference(_t(s), _t(items), chunk=64)
    window_1 = (l >= softmax_lse.WINDOW1_FLOOR).numpy()
    assert {0.3: window_1.all(), 1.0: True, 1.5: not window_1.any()}[scale]
    np.testing.assert_allclose(softmax_lse.select_shift_window(shift, l, l2).numpy(), expected, rtol=1e-5, atol=1e-6)


def test_bounded_shift_past_the_contract_gives_the_same_minus_inf_rows() -> None:
    """Rows whose bound gap passes ~170 flush both windows: -inf in both
    packages, never NaN. Rows under a gap of 120 stay exact. Rows between are
    left out: XLA flushes subnormals to zero and the twin (like the card)
    keeps them, so near window 2's horizon JAX may give -inf where the port
    gives a finite value."""
    s, items = _shift_case(1.0, m=80, n=200, seed=2)
    s = (s * np.linspace(0.2, 9.0, 80, dtype=np.float32)[:, None] * 1.6).astype(np.float32)
    gap = _bound_gap(s, items)
    inside, outside = gap < 120.0, gap > 170.0
    assert inside.sum() >= 10 and outside.sum() >= 10
    expected = np.asarray(jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True, True))
    got = softmax_lse.streaming_lse(_t(s), _t(items), bounded_shift=True).numpy()
    assert not np.isnan(got).any() and not np.isnan(expected).any()
    np.testing.assert_array_equal(np.isneginf(got[outside]), np.ones(outside.sum(), bool))
    np.testing.assert_array_equal(np.isneginf(expected[outside]), np.ones(outside.sum(), bool))
    assert np.isfinite(got[inside]).all()
    np.testing.assert_allclose(got[inside], expected[inside], rtol=1e-5, atol=1e-6)


def test_bounded_shift_gradients_match_jax_and_a_bias_ignores_it() -> None:
    """The backward is kernel 9's (or 10 + 11's) from the saved lse, as JAX's
    custom VJP; with a bias JAX runs kernel 8 whatever ``bounded_shift`` says,
    and so does the port."""
    s, items = _shift_case(1.0, m=45, n=150, seed=4)
    dlse = np.random.default_rng(9).normal(size=45).astype(np.float32)

    def value(s_, i_):
        return jnp.sum(jax_softmax_lse.streaming_lse(s_, i_, None, 16, 64, True, True) * dlse)

    eds, edi = jax.grad(value, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(items))
    ts, ti = _t(s, True), _t(items, True)
    (softmax_lse.streaming_lse(ts, ti, bounded_shift=True) * _t(dlse)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(eds), atol=1e-5 * np.abs(eds).max())
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(edi), atol=1e-5 * np.abs(edi).max())
    bias = np.zeros(150, np.float32)
    bias[-9:] = -1e30
    with_shift = softmax_lse.streaming_lse(_t(s), _t(items), _t(bias), bounded_shift=True)
    torch.testing.assert_close(with_shift, softmax_lse.streaming_lse(_t(s), _t(items), _t(bias)), rtol=0, atol=0)
    expected = jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), jnp.asarray(bias), 16, 64, True, True)
    np.testing.assert_allclose(with_shift.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


def _biased_case(m: int, n: int, d: int, invalid: str):
    """Inputs of the biased lse: ``invalid`` rows carry -1e30 ("tail": the last
    5, "scattered": every seventh, "all": a shard with no valid row, "chunk":
    the second ``LSE_CHUNK`` item chunk whole and the last 5 rows)."""
    rng, s, items = _lse_inputs(m, n, d, seed=7 * m + n)
    bias = np.zeros(n, np.float32)
    if invalid == "tail":
        bias[-5:] = -1e30
    elif invalid == "scattered":
        bias[::7] = -1e30
    elif invalid == "all":
        bias[:] = -1e30
    elif invalid == "chunk":
        bias[softmax_lse.LSE_CHUNK : 2 * softmax_lse.LSE_CHUNK] = -1e30
        bias[-5:] = -1e30
    dlse = rng.normal(size=m).astype(np.float32)  # mixed sign
    dlse[::6] = 0.0
    return s, items, bias, dlse


BIASED_CASES = [(50, 300, 32, "tail"), (64, 129, 16, "scattered"), (33, 70, 32, "none"), (20, 40, 16, "all")]
# and for the forward alone, in the card's chunks: ragged M and N over two and three chunks, a whole chunk invalid
BIASED_FWD_CASES = BIASED_CASES + [
    (45, 2111, 32, "tail"), (70, 2300, 128, "none"), (37, 4500, 128, "chunk"), (29, 4400, 32, "chunk")]


@pytest.mark.parametrize("m,n,d,invalid", BIASED_FWD_CASES)
def test_streaming_lse_with_bias_matches_jax(m: int, n: int, d: int, invalid: str) -> None:
    """Kernel 8's twin, which walks the catalog in the card's chunks (``LSE_CHUNK``
    rows, each chunk's (max, Σexp) of the biased logits with the max from
    -1e30, then the combine), and the CPU ``streaming_lse`` that takes it,
    against the JAX biased kernel in interpret mode, 1e-5 relative per row. A
    zero bias gives kernel 6's twin bit for bit; a wholly invalid chunk adds
    nothing."""
    s, items, bias, _ = _biased_case(m, n, d, invalid)
    expected = np.asarray(
        jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), jnp.asarray(bias), 16, 64, True)
    )
    got = softmax_lse.streaming_lse(_t(s), _t(items), _t(bias))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)
    m_parts, l_parts = [], []
    for start in range(0, n, softmax_lse.LSE_CHUNK):  # the chunks, written out
        chunk = slice(start, start + softmax_lse.LSE_CHUNK)
        logits = _t(s) @ _t(items[chunk]).T + _t(bias[chunk])[None, :]
        m_parts.append(torch.clamp(logits.max(dim=1).values, min=-1e30))
        l_parts.append(torch.exp(logits - m_parts[-1][:, None]).sum(dim=1))
    chunked = softmax_lse.combine_lse_partials(torch.stack(m_parts), torch.stack(l_parts))
    torch.testing.assert_close(got, chunked, rtol=0, atol=0)
    small = softmax_lse.streaming_lse_bias_reference(_t(s), _t(items), _t(bias), chunk=7).numpy()
    np.testing.assert_allclose(small, expected, rtol=1e-5, atol=1e-6)
    if invalid == "none":  # kernel 8 with a zero bias is kernel 6
        assert torch.equal(got, softmax_lse.streaming_lse_partials_reference(_t(s), _t(items)))
    if invalid == "chunk":  # the invalid chunk left out: the lse of the valid columns alone
        valid = bias == 0
        alone = softmax_lse.streaming_lse_partials_reference(_t(s), _t(items[valid]))
        torch.testing.assert_close(got, alone, rtol=1e-6, atol=0)
    if invalid == "all":  # -1e30 + log(count): finite, never NaN or inf
        np.testing.assert_array_equal(got.numpy(), np.full(m, -1e30, np.float32))


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("m,n,d,invalid", BIASED_CASES)
def test_streaming_lse_vjp_matches_jax(monkeypatch, m: int, n: int, d: int, invalid: str, route: str) -> None:
    """The generic VJP (kernel 9's twin, or 10 + 11's with the partials budget
    forced to 0, as tests/ops/test_softmax_lse.py does for JAX) against
    ``jax.grad`` of the JAX kernel, 1e-5 of each output's largest entry."""
    s, items, bias, dlse = _biased_case(m, n, d, invalid)
    if route == "split":
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
        monkeypatch.setattr(jax_softmax_lse, "_FUSED_BWD_PARTIALS_BUDGET", 0)
    with_bias = invalid != "none"

    def value(s_, i_):
        lse = jax_softmax_lse.streaming_lse(s_, i_, jnp.asarray(bias) if with_bias else None, 16, 64, True)
        return jnp.sum(lse * dlse)

    eds, edi = jax.grad(value, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(items))
    ts, ti = _t(s, True), _t(items, True)
    lse = softmax_lse.streaming_lse(ts, ti, _t(bias) if with_bias else None)
    (lse * _t(dlse)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(eds), atol=1e-5 * max(np.abs(eds).max(), 1e-30))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(edi), atol=1e-5 * max(np.abs(edi).max(), 1e-30))
    if invalid in ("tail", "scattered"):  # an invalid row's gradient is exactly 0
        assert not ti.grad.numpy()[bias < 0].any()


def test_streaming_lse_vjp_routes_agree(monkeypatch) -> None:
    """Fused (one ds partial per chunk, summed at the end) against split (a
    running sum): the twins keep the kernels' two summation orders."""
    s, items, bias, dlse = _biased_case(70, 5000, 32, "tail")
    lse = softmax_lse.streaming_lse_fwd(_t(s), _t(items), _t(bias))
    fused = softmax_lse.streaming_lse_bwd(_t(s), _t(items), _t(bias), lse, _t(dlse))
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    split = softmax_lse.streaming_lse_bwd(_t(s), _t(items), _t(bias), lse, _t(dlse))
    for got, expected in zip(fused, split):
        np.testing.assert_allclose(got.numpy(), expected.numpy(), atol=1e-5 * expected.abs().max().item())
    # above the budget the plan says split: a catalog of 2M items at the training width
    assert softmax_lse.fused_bwd_plan(51200, 2_000_000, 128, 132)[2] > 512 * 1024 * 1024
    # the tensor-core tile at d = 128: 8 chunks x 16 groups of 25 tiles of 128 rows, 128 blocks, 1 per SM
    plan = softmax_lse.fused_bwd_plan(51200, 15872, 128, 132)
    assert plan == (25, 16, (8 * 51200 + 16 * 15872) * 128 * 4) and plan[2] <= 512 * 1024 * 1024
    # the SIMT tile at d = 256: 64-row tiles, 2 blocks per SM (20,480 items: 10 chunks x 26 groups)
    assert softmax_lse.fused_bwd_plan(51200, 20480, 256, 132) == (31, 26, (10 * 51200 + 26 * 20480) * 256 * 4)


@pytest.mark.parametrize(
    "m,n,d,plan",
    [(51200, 15872, 128, (4, 3968)), (51200, 131072, 128, (4, 32768)), (51200, 65536, 128, (4, 16384)),
     (25600, 7936, 128, (3, 2688)), (25600, 3959, 128, (3, 1344)), (51200, 15872, 64, (4, 3968)),
     (300, 100, 32, (2, 64)), (51200, 20480, 256, (1, 20480)), (51200, 15872, 16, (1, 15872))],
)
def test_split_bwd_plan_is_pinned(m: int, n: int, d: int, plan: tuple) -> None:
    """The split ds kernel's grid on an H100 (132 multiprocessors): at the
    training width 400 session tiles x 4 item chunks, 1,600 blocks of one per
    multiprocessor, whose last wave is 93% full (one chunk: 400 blocks, the
    fourth wave 4 blocks alone); the same 4 chunks at 65,536 and 131,072
    items, so the ds partials stay 4 x M x D floats whatever the catalog;
    no more chunks than item tiles; the SIMT tile (D = 16, 256) one chunk."""
    assert softmax_lse.split_bwd_plan(m, n, d, 132) == plan
    chunks, rows = plan
    assert rows % softmax_lse.TILE == 0 and -(-n // rows) == chunks
    if (m, n, d) == (51200, 15872, 128):
        blocks = -(-m // 128) * chunks
        assert blocks == 1600 and blocks / (-(-blocks // 132) * 132) > 0.93
    if d == 128 and m == 51200:  # far under the budget, and not growing with the catalog
        assert chunks * m * d * 4 == 4 * 51200 * 128 * 4 < softmax_lse.FUSED_BWD_PARTIALS_BUDGET // 5


def test_split_order_twin_sums_running_chunk_partials() -> None:
    """The twins' split order is the split ds kernel's: one running sum per
    item chunk of the plan (steps of ``chunk`` rows that never cross a chunk's
    end), the chunk sums added at the end; di is per item row either way."""
    rng, s, items = _lse_inputs(40, 700, 32, seed=17)
    z = np.full(40, 3.0, np.float32)
    chunks, rows = softmax_lse.split_bwd_plan(40, 700, 32, 132)
    assert chunks > 1 and rows % 5  # steps of 5 rows cut at each chunk's end
    ds, di = softmax_lse.softmax_grads_from_z_reference(_t(s), _t(items), _t(z), chunk=5, partials=False)
    st, it = _t(s), _t(items)
    parts = []
    for lo in range(0, 700, rows):
        part = None
        for start in range(lo, min(lo + rows, 700), 5):
            block = it[start : min(start + 5, lo + rows, 700)]
            term = torch.exp(st @ block.T - 3.0) @ block
            part = term if part is None else part + term
        parts.append(part)
    assert torch.equal(ds, torch.stack(parts).sum(dim=0))
    torch.testing.assert_close(di, torch.exp(st @ it.T - 3.0).T @ st, rtol=1e-6, atol=1e-6)


def test_streaming_lse_bias_gets_no_gradient() -> None:
    s, items, bias, _ = _biased_case(8, 20, 16, "tail")
    with pytest.raises(ValueError, match="constant validity mask"):
        softmax_lse.streaming_lse(_t(s, True), _t(items), _t(bias, True))


@pytest.mark.parametrize("offset_rows", [0, 3, 17])
def test_hash_masks_of_a_batch_shard_are_rows_of_the_global_mask(offset_rows: int) -> None:
    """A rank holding rows [b0, b0 + b) draws those rows of the global mask:
    dropout, device negatives and the attention mask."""
    words, shape, b = (123456789, -987654321), (24, 5, 7), 4
    inner = 5 * 7
    full = dropout.hash_keep_mask(words, shape, 0.3)
    part = dropout.hash_keep_mask(words, (b, 5, 7), 0.3, offset=offset_rows * inner)
    assert torch.equal(part, full[offset_rows : offset_rows + b])
    full_ints = dropout.hash_uniform_ints(words, shape, 1, 301)
    part_ints = dropout.hash_uniform_ints(words, (b, 5, 7), 1, 301, offset=offset_rows * inner)
    assert torch.equal(part_ints, full_ints[offset_rows : offset_rows + b])
    seed, heads, length = 2**31 - 5, 2, 6
    full_attn = attention.dropout_keep_mask(seed, 24, heads, length, 0.2)
    shifted = dropout.shifted_attention_seed(seed, offset_rows, heads)
    assert -(2**31) <= shifted < 2**31
    part_attn = attention.dropout_keep_mask(shifted, b, heads, length, 0.2)
    assert torch.equal(part_attn, full_attn[offset_rows : offset_rows + b])
    layer = dropout.HashDropout(0.3).train()
    layer.dropout_generator = torch.Generator().manual_seed(1)
    whole = layer(torch.ones(shape))
    layer.dropout_generator = torch.Generator().manual_seed(1)
    dropout.set_batch_offset(layer, offset_rows)
    assert torch.equal(layer(torch.ones((b, 5, 7))), whole[offset_rows : offset_rows + b])


def _ce_case(m: int, n: int, d: int = 32):
    rng, s, items = _lse_inputs(m, n, d, seed=3 * m + n)
    y = rng.integers(0, n, size=m).astype(np.int32)
    coeff = rng.uniform(0.0, 0.05, size=m).astype(np.float32)
    coeff[::5] = 0.0  # ignored rows
    lse = np.asarray(jax_softmax_lse.reference_lse(jnp.asarray(s), jnp.asarray(items)))
    with np.errstate(divide="ignore"):
        z = (lse - np.log(coeff)).astype(np.float32)
    return s, items, z, y, coeff


@pytest.mark.parametrize("partials", [True, False])
@pytest.mark.parametrize("m,n", [(50, 300), (64, 129)])
def test_softmax_ce_grads_from_z_matches_jax(m: int, n: int, partials: bool) -> None:
    """Kernel 7's twin in the one-pass order (``partials=True``: one ds
    partial per item chunk, summed at the end) and in the two-launch order (a
    running sum), chunked finely so that the orders differ, and the public op,
    against the JAX op in interpret mode."""
    s, items, z, y, coeff = _ce_case(m, n)
    ds_jax, di_jax = jax_softmax_lse.softmax_ce_grads_from_z(*map(jnp.asarray, (s, items, z, y, coeff)), 16, 64, True)
    args = (_t(s), _t(items), _t(z), _t(y.astype(np.int64)), _t(coeff))
    for got in (softmax_lse.softmax_ce_grads_from_z(*args),
                softmax_lse.softmax_ce_grads_from_z_reference(*args, chunk=7, partials=partials)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ds_jax), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(di_jax), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("budget,fused", [(None, True), (40_000, False)])
def test_softmax_ce_grads_from_z_takes_the_order_of_the_card(monkeypatch, budget, fused: bool) -> None:
    """On the CPU the CE gradients take the summation order the card would
    take: the one pass while the fused plan's partials fit the budget, the
    two launches when they do not but the JAX rule keeps kernel 7 (at 50 x
    300 x 32 the rule counts 32,768 bytes, the plan 44,800)."""
    m, n, d = 50, 300, 32
    if budget is not None:
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", budget)
    assert not softmax_lse.ce_takes_split_route(m, n, d)
    assert softmax_lse._fused_on_the_card(m, n, d) == fused
    orders = []
    twin = softmax_lse.softmax_ce_grads_from_z_reference
    monkeypatch.setattr(softmax_lse, "softmax_ce_grads_from_z_reference",
                        lambda *a, **k: orders.append(k["partials"]) or twin(*a, **k))
    s, items, z, y, coeff = _ce_case(m, n, d)
    args = (_t(s), _t(items), _t(z), _t(y.astype(np.int64)), _t(coeff))
    got = softmax_lse.softmax_ce_grads_from_z(*args)
    assert orders == [fused]
    for g, expected in zip(got, twin(*args, partials=fused)):
        assert torch.equal(g, expected)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x kept to 10 mantissa bits, rounded to nearest
    with ties away from zero (half a TF32 ulp added to the magnitude bits,
    then the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + 0x1000) & 0xFFFFE000
    return torch.where(rounded >= 2**31, rounded - 2**32, rounded).to(torch.int32).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b from TF32 halves: 3xTF32 (lo·hi + hi·lo, then hi·hi) or, with
    ``three`` False, plain TF32 (hi·hi)."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    if not three:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def test_tf32_rounding_is_round_to_nearest_away() -> None:
    one, ulp = 1.0, 2.0**-10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4, 3.0, -0.0])
    expected = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, -0.0])
    assert torch.equal(_tf32_rna(x), expected)
    hi = _tf32_rna(x)
    assert torch.equal(_tf32_rna(hi), hi)  # TF32 values are fixed points


def _split_order_tf32(s: torch.Tensor, items: torch.Tensor, pw: torch.Tensor, three: bool) -> tuple:
    """The split kernels' order at tile grain: ds as one running sum of
    64-item tiles per item chunk of the plan, the chunks summed at the end;
    di as one running sum of 128-session tiles per item row."""
    m, n = pw.shape
    _, rows = softmax_lse.split_bwd_plan(m, n, s.shape[1], 132)
    parts = []
    for lo in range(0, n, rows):
        part = torch.zeros_like(s)
        for start in range(lo, min(lo + rows, n), 64):
            part = part + _mm_tf32(pw[:, start : start + 64], items[start : start + 64], three)
        parts.append(part)
    di = torch.zeros_like(items)
    for start in range(0, m, 128):
        di = di + _mm_tf32(pw[start : start + 128].T, s[start : start + 128], three)
    return torch.stack(parts).sum(dim=0), di


@pytest.mark.parametrize("order", ["fused", "split"])
@pytest.mark.parametrize("d", [32, 128])
def test_ce_gradients_in_3xtf32_pass_the_card_tolerance(d: int, order: str) -> None:
    """The arithmetic of the tensor-core tile on the CPU: the three products
    of the CE gradients (logits, ds, di) from TF32 halves, the probabilities
    between them as the kernel forms them, at the input scale of the card's
    kernel phases (sessions N(0, 1), items 0.1 N(0, 1)), summed whole (the
    one pass) or in the split kernels' order (ds per item chunk of the plan,
    running sums over tiles) against the exact f32 twin in the same order.
    3xTF32 stays within 1e-5 of the twin's largest entry; plain TF32 lands
    above 1e-4, the loosest limit the card holds a kernel to, so no limit
    there passes it."""
    m, n = 300, 1000
    rng = np.random.default_rng(d)
    s = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    items = torch.from_numpy((0.1 * rng.normal(size=(n, d))).astype(np.float32))
    y = torch.from_numpy(rng.integers(1, n, size=m))
    coeff = torch.full((m,), 1.0 / m)
    coeff[::5] = 0.0
    z = softmax_lse.streaming_lse_reference(s, items) - torch.log(coeff)
    exact = softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=order == "fused")
    if order == "split":
        assert softmax_lse.split_bwd_plan(m, n, d, 132)[0] > 1
    for three in (True, False):
        pw = torch.exp(_mm_tf32(s, items.T, three) - z[:, None])
        pw[torch.arange(m), y] -= coeff
        if order == "fused":
            got = (_mm_tf32(pw, items, three), _mm_tf32(pw.T, s, three))
        else:
            got = _split_order_tf32(s, items, pw, three)
        worst = max(((g - e).abs().max() / e.abs().max()).item() for g, e in zip(got, exact))
        assert worst <= 1e-5 if three else worst > 1e-4, (three, worst)


def _carried_max_lse_tf32(s: torch.Tensor, items: torch.Tensor, three: bool) -> torch.Tensor:
    """Kernel 15's arithmetic on the tensor-core tile in its cluster's order:
    rank q of ``lse_cluster_plan`` walks its item rows in 64-row tiles, the
    logits from TF32 halves, one running (max from -1e30, Σexp) per row; rank
    0 then merges the ranks' pairs in rank order (an empty rank adds (-1e30,
    0))."""
    n = items.shape[0]
    cluster, rows = softmax_lse.lse_cluster_plan(n)
    m = torch.full((s.shape[0],), softmax_lse.NEG_BIG)
    l = torch.zeros((s.shape[0],))
    for q in range(cluster):
        m_q, l_q = torch.full_like(m, softmax_lse.NEG_BIG), torch.zeros_like(l)
        for start in range(q * rows, min(n, (q + 1) * rows), softmax_lse.TILE):
            logits = _mm_tf32(s, items[start : start + softmax_lse.TILE].T.contiguous(), three)
            m_new = torch.maximum(m_q, logits.max(dim=1).values)
            l_q = l_q * torch.exp(m_q - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
            m_q = m_new
        m_new = torch.maximum(m, m_q)
        l = l * torch.exp(m - m_new) + l_q * torch.exp(m_q - m_new)
        m = m_new
    return m + torch.log(l)


@pytest.mark.parametrize(
    "m,n,d",
    [(70, 2177, 32), (64, 40, 64), (100, 576, 128), (130, 1000, 64)],
    ids=["ragged_m_last_rank_empty", "under_one_tile", "three_ranks_empty", "ragged_m_over_a_tile"],
)
def test_carried_max_lse_in_3xtf32_cluster_order_matches_jax(monkeypatch, m: int, n: int, d: int) -> None:
    """Kernel 15 on the tensor-core tile, modelled on the CPU: 3xTF32 logits
    in the cluster's order within 1e-6 relative per row (``LSE_TC_RTOL`` of
    chip_smoke.py) of the JAX carried-max forward (``_lse_fwd_tail_kernel``,
    ``_USE_PARTIALS_FWD = False``, interpret mode); plain TF32 products land
    above that limit. The cases: M not a multiple of 128; a catalog under one
    item tile (one rank); catalogs whose plan leaves one or three ranks with
    no tile."""
    rng = np.random.default_rng(m * n + d)
    s = rng.normal(size=(m, d)).astype(np.float32)
    items = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    monkeypatch.setattr(jax_softmax_lse, "_USE_PARTIALS_FWD", False)
    expected = _t(np.array(jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True)))
    cluster, rows = softmax_lse.lse_cluster_plan(n)
    empty = cluster - -(-n // rows)
    assert empty == {2177: 1, 40: 0, 576: 3, 1000: 0}[n] and (cluster == 1) == (n <= softmax_lse.TILE)
    errors = {}
    for three in (True, False):
        got = _carried_max_lse_tf32(_t(s), _t(items), three)
        errors[three] = ((got - expected).abs() / expected.abs()).max().item()
    assert errors[True] <= 1e-6 < errors[False], errors


def _bounded_shift_lse_tf32(s: torch.Tensor, items: torch.Tensor, three: bool) -> torch.Tensor:
    """Kernel 16's arithmetic on the tensor-core tile in its order: per
    ``LSE_CHUNK`` item chunk, the 64-row item tiles' logits from TF32 halves,
    x = logit − shift, the sums of exp(x) and exp(x + 64) added tile by tile;
    the chunks' sums then added in order (the wrapper's fixed-order sum) and
    the window chosen per row."""
    n = items.shape[0]
    shift = softmax_lse.lse_shift(s, items)
    l_parts, l2_parts = [], []
    for lo in range(0, n, softmax_lse.LSE_CHUNK):
        l, l2 = torch.zeros_like(shift), torch.zeros_like(shift)
        for start in range(lo, min(n, lo + softmax_lse.LSE_CHUNK), softmax_lse.TILE):
            x = _mm_tf32(s, items[start : start + softmax_lse.TILE].T.contiguous(), three) - shift[:, None]
            l = l + torch.exp(x).sum(dim=1)
            l2 = l2 + torch.exp(x + softmax_lse.WINDOW2_OFFSET).sum(dim=1)
        l_parts.append(l)
        l2_parts.append(l2)
    return softmax_lse.select_shift_window(shift, torch.stack(l_parts).sum(dim=0), torch.stack(l2_parts).sum(dim=0))


@pytest.mark.parametrize(
    "scale,m,n,d,seed,window_1",
    [(0.3, 60, 300, 32, 0, 1.0), (1.5, 60, 300, 32, 0, 0.0), (1.0, 60, 300, 32, 0, 5 / 60),
     (1.0, 130, 1000, 64, 1, 0.0), (0.3, 64, 40, 128, 2, 1.0), (0.5, 130, 2177, 64, 4, 1.0)],
    ids=["window_1", "window_2", "both_windows", "ragged_m", "under_one_tile", "ragged_last_chunk"],
)
def test_bounded_shift_lse_in_3xtf32_tile_order_matches_jax(
    scale: float, m: int, n: int, d: int, seed: int, window_1: float
) -> None:
    """Kernel 16 on the tensor-core tile, modelled on the CPU: 3xTF32 logits
    in 64-row item tiles inside ``LSE_CHUNK`` chunks, per-chunk sums of both
    windows added over the chunks in order, within 1e-6 relative per row
    (``LSE_TC_RTOL`` of chip_smoke.py) of the JAX fixed-shift kernel
    (``_lse_shift_kernel``, interpret mode); plain TF32 products land above
    that limit. The cases: every row in window 1, every row in window 2, rows
    in both, M not a multiple of 128, a catalog under one item tile, a
    catalog whose last chunk is ragged (2,177 = 2,048 + 129 rows). Every
    bound gap stays under 120 (the band up to 170 is left out, as in the
    other tests)."""
    s, items = _shift_case(scale, m, n, d, seed)
    assert _bound_gap(s, items).max() < 120.0
    _, l, _ = softmax_lse.lse_shift_sums_reference(_t(s), _t(items))
    assert (l >= softmax_lse.WINDOW1_FLOOR).float().mean().item() == pytest.approx(window_1)
    ragged_chunks = n > softmax_lse.LSE_CHUNK and n % softmax_lse.LSE_CHUNK > 0
    assert (n <= softmax_lse.TILE, ragged_chunks) == (n == 40, n == 2177)
    expected = _t(np.array(jax_softmax_lse.streaming_lse(jnp.asarray(s), jnp.asarray(items), None, 16, 64, True, True)))
    errors = {}
    for three in (True, False):
        got = _bounded_shift_lse_tf32(_t(s), _t(items), three)
        errors[three] = ((got - expected).abs() / expected.abs()).max().item()
    assert errors[True] <= 1e-6 < errors[False], errors


def _attention_fwd_tf32(q, k, v, bias, scale: float, keep, three: bool) -> tuple:
    """Kernel 2's arithmetic on the tensor-core tile: per 32-key unit in key
    order, s from TF32 halves, times the scale, plus the bias; the online
    softmax of each row (running max, correction of the sum and the output);
    p times the scaled keep bits into the value product from TF32 halves.
    The lse is pre-dropout."""
    b, h, l, dh = q.shape
    m = torch.full((b, h, l), float("-inf"))
    total = torch.zeros((b, h, l))
    acc = torch.zeros((b, h, l, dh))
    for kc in range(0, l, 32):
        keys = slice(kc, min(kc + 32, l))
        s = _mm_tf32(q, k[:, :, keys].transpose(-1, -2).contiguous(), three) * scale + bias[..., keys]
        m_new = torch.maximum(m, s.max(dim=-1).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        total = total * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mm_tf32((p * keep[..., keys]).contiguous(), v[:, :, keys], three)
        m = m_new
    return acc / total[..., None], m + torch.log(total)


def _attention_bwd_tf32(q, k, v, bias, lse, delta, dout, scale: float, keep, three: bool) -> tuple:
    """Kernel 5's arithmetic on the tensor-core tile: per key tile of
    ``BWD_KEY_TILE`` and query tile of ``BWD_QUERY_TILE`` in order, s^T and
    dp^T from TF32 halves, p, p_drop and ds in f32, dv += p_drop^T dout and
    dk += ds^T q from TF32 halves (dk times the scale at the end), and dq of
    the query tile, ds k times the scale, written on the first key tile and
    added on later ones."""
    l = q.shape[2]
    keep_t = keep.transpose(-1, -2)
    bias_t = bias.transpose(-1, -2)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for k0 in range(0, l, attention.BWD_KEY_TILE):
        keys = slice(k0, min(k0 + attention.BWD_KEY_TILE, l))
        dk_tile = torch.zeros_like(k[:, :, keys])
        dv_tile = torch.zeros_like(v[:, :, keys])
        for q0 in range(0, l, attention.BWD_QUERY_TILE):
            rows = slice(q0, min(q0 + attention.BWD_QUERY_TILE, l))
            st = _mm_tf32(k[:, :, keys], q[:, :, rows].transpose(-1, -2).contiguous(), three)
            dpt = _mm_tf32(v[:, :, keys], dout[:, :, rows].transpose(-1, -2).contiguous(), three)
            p = torch.exp(st * scale + bias_t[..., keys, rows] - lse[:, :, None, rows])
            scaled_keep = keep_t[..., keys, rows]
            ds = p * (dpt * scaled_keep - delta[:, :, None, rows])
            dv_tile = dv_tile + _mm_tf32((p * scaled_keep).contiguous(), dout[:, :, rows], three)
            dk_tile = dk_tile + _mm_tf32(ds.contiguous(), q[:, :, rows], three)
            dq[:, :, rows] = dq[:, :, rows] + _mm_tf32(ds.transpose(-1, -2).contiguous(), k[:, :, keys], three) * scale
        dk[:, :, keys] = dk_tile * scale
        dv[:, :, keys] = dv_tile
    return dq, dk, dv


@pytest.mark.parametrize("bias_kind", ["causal", "key_padding"])
@pytest.mark.parametrize("l,dh", [(100, 32), (100, 64), (257, 32), (257, 64)])
def test_attention_in_3xtf32_passes_the_card_tolerance(l: int, dh: int, bias_kind: str) -> None:
    """The arithmetic of kernels 2 and 5 on the tensor-core tile, on the CPU:
    their products from TF32 halves in the kernels' order (the forward's
    online softmax over 32-key units, the backward's key and query tiles) at
    the input scale of the card's kernel phases (q, k, v, dout N(0, 1)), with
    dropout 0.2, against the exact f32 twins. 3xTF32 stays within the card's
    absolute limit of 1e-5 (``ATTN_TOL`` in chip_smoke.py) on out, lse, dq,
    dk and dv; plain TF32 lands above it."""
    rng = np.random.default_rng(l + dh)
    b, h, rate, seed = 2, 2, 0.2, 31337
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, h, l, dh)).astype(np.float32)) for _ in range(4))
    bias = _causal_bias(l)
    if bias_kind == "key_padding":  # left padding, the diagonal kept, as the backbone builds it
        pad = np.arange(l)[None, :] < (l - rng.integers(1, l + 1, size=b))[:, None]
        bias = np.where(pad, MASK_VALUE, 0.0)[:, None, None, :] + bias
        bias[:, :, np.arange(l), np.arange(l)] = 0.0
    bias = torch.from_numpy(bias.astype(np.float32))
    scale = 1.0 / dh**0.5
    keep = attention.dropout_keep_mask(seed, b, h, l, rate) / (1.0 - rate)
    out, lse = attention.attention_reference(q, k, v, bias, scale, rate, seed)
    delta = (dout * out).sum(dim=-1)
    exact = (out, lse, *attention.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, rate, seed))
    for three in (True, False):
        got = (*_attention_fwd_tf32(q, k, v, bias, scale, keep, three),
               *_attention_bwd_tf32(q, k, v, bias, lse, delta, dout, scale, keep, three))
        worst = max((g - e).abs().max().item() for g, e in zip(got, exact))
        assert worst <= 1e-5 if three else worst > 1e-5, (three, worst)


def _stu_fwd_tf32(q, k, v, bias, allowed, timeline, three: bool) -> torch.Tensor:
    """Kernel 17's arithmetic on the tensor-core tile: per 32-key unit in key
    order, s from TF32 halves plus the bias, a = silu(s) / L times the mask
    (allowed · tl_q · tl_k) in f32, and a v from TF32 halves added onto the
    running output."""
    l = q.shape[2]
    mask = (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None]
    acc = torch.zeros(q.shape[:3] + (v.shape[3],))
    for kc in range(0, l, 32):
        keys = slice(kc, min(kc + 32, l))
        s = _mm_tf32(q, k[:, :, keys].transpose(-1, -2).contiguous(), three) + bias[:, None, :, keys]
        a = s * torch.sigmoid(s) / l * mask[..., keys]
        acc = acc + _mm_tf32(a.contiguous(), v[:, :, keys], three)
    return acc


@pytest.mark.parametrize("mask_kind", ["causal", "key_padding"])
@pytest.mark.parametrize("l,d", [(100, 32), (100, 64), (257, 32), (257, 64)])
def test_stu_forward_in_3xtf32_passes_the_card_tolerance(l: int, d: int, mask_kind: str) -> None:
    """The arithmetic of kernel 17 on the tensor-core tile, on the CPU: its two
    products from TF32 halves per 32-key unit, at the input scale of the card's
    kernel phases (q, k, v N(0, 1), the time-plus-position bias), with left
    padding and a fully padded row, against the exact f32 twin. 3xTF32 stays
    within the card's limit, ``STU_FWD_TOL`` (1e-5) times the twin's largest
    entry where that is above 1; plain TF32 lands above it. The padded row
    gives exact zeros either way."""
    rng = np.random.default_rng(l + d)
    b, h = 3, 2
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, l, d)).astype(np.float32)) for _ in range(3))
    ts = torch.from_numpy(1_600_000_000 + np.sort(rng.integers(0, 86400 * 30, size=(b, l + 2)), axis=1))
    tw = torch.from_numpy((0.1 * rng.normal(size=(129,))).astype(np.float32))
    pw = torch.from_numpy((0.1 * rng.normal(size=(2 * l - 1,))).astype(np.float32))
    bias = stu_attention.combined_bias(stu_attention.time_buckets(ts, l, 128), tw, pw, l, torch.device("cpu"))
    real = np.arange(l)[None, :] >= rng.integers(0, l, size=b)[:, None]  # left padding
    real[0], real[-1] = True, False
    timeline = torch.from_numpy(real.astype(np.float32))
    allowed = np.tril(np.ones((l, l), np.float32))[None]
    if mask_kind == "key_padding":
        allowed = np.maximum(allowed * real[:, None, :], np.eye(l, dtype=np.float32)[None])
    allowed = torch.from_numpy(np.ascontiguousarray(allowed, dtype=np.float32))
    exact = stu_attention.stu_reference(q, k, v, bias, allowed, timeline)
    limit = 1e-5 * max(1.0, exact.abs().max().item())
    for three in (True, False):
        got = _stu_fwd_tf32(q, k, v, bias, allowed, timeline, three)
        worst = (got - exact).abs().max().item()
        assert worst <= limit if three else worst > limit, (three, worst, limit)
        assert not got[-1].any()


# ------------------------------------------------------------------ losses


def _loss_inputs(b: int, l: int, c: int, seed: int, n_items: int):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, l, c)).astype(np.float32)
    y = rng.integers(1, n_items, size=(b, l))
    y[:, : l // 3] = 0  # PAD targets
    w = rng.uniform(0.5, 2.0, size=(b, l)).astype(np.float32)
    return logits, y, w


@pytest.mark.parametrize("name", ["softmax", "BCE", "gBCE", "sampled_softmax"])
def test_losses_and_gradients_match_jax(name: str) -> None:
    n_items = 40
    logits, y, w = _loss_inputs(3, 9, n_items if name == "softmax" else 6, seed=len(name), n_items=n_items)
    jax_fns = {
        "softmax": jax_losses.softmax_loss,
        "BCE": jax_losses.bce_loss,
        "gBCE": lambda lg, yy, ww: jax_losses.gbce_loss(lg, yy, ww, n_items - 1, 5, 0.2),
        "sampled_softmax": jax_losses.sampled_softmax_loss,
    }
    port_fns = {
        "softmax": losses.softmax_loss,
        "BCE": losses.bce_loss,
        "gBCE": lambda lg, yy, ww: losses.gbce_loss(lg, yy, ww, n_items - 1, 5, 0.2),
        "sampled_softmax": losses.sampled_softmax_loss,
    }
    value, grad = jax.value_and_grad(jax_fns[name])(jnp.asarray(logits), jnp.asarray(y, jnp.int32), jnp.asarray(w))
    lt = _t(logits, True)
    got = port_fns[name](lt, _t(y), _t(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(value), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad), atol=1e-5, rtol=1e-5)
    assert losses.requires_negatives(name) == jax_losses.requires_negatives(name)


def test_fused_softmax_loss_value_and_gradients_match_jax() -> None:
    rng = np.random.default_rng(4)
    b, l, d, n = 3, 11, 32, 301
    s = (0.5 * rng.normal(size=(b, l, d))).astype(np.float32)
    items = (0.5 * rng.normal(size=(n, d))).astype(np.float32)
    y = rng.integers(1, n, size=(b, l))
    y[0, :4] = 0
    w = rng.uniform(0.0, 2.0, size=(b, l)).astype(np.float32)
    w[1, 2] = 0.0

    def jax_fused(js, ji, jw):
        return jax_losses.fused_softmax_loss(js, ji, jnp.asarray(y, jnp.int32), jw, chunk=64)

    def jax_plain(js, ji, jw):
        logits = jnp.einsum("bld,nd->bln", js, ji)
        return jax_losses.softmax_loss(logits, jnp.asarray(y, jnp.int32), jw)

    st, it, wt = _t(s, True), _t(items, True), _t(w, True)
    got = losses.fused_softmax_loss(st, it, _t(y), wt)
    (0.7 * got).backward()  # a non-unit upstream cotangent
    for fn in (jax_fused, jax_plain):
        value, grads = jax.value_and_grad(lambda *a: 0.7 * fn(*a), argnums=(0, 1, 2))(
            *map(jnp.asarray, (s, items, w))
        )
        np.testing.assert_allclose(0.7 * got.item(), float(value), rtol=1e-5)
        for port_grad, jax_grad in zip((st.grad, it.grad, wt.grad), grads):
            np.testing.assert_allclose(port_grad.numpy(), np.asarray(jax_grad), atol=1e-5, rtol=1e-5)


def test_ce_from_lse_matches_jax() -> None:
    rng = np.random.default_rng(8)
    b, l, d, n = 2, 7, 16, 90
    s = rng.normal(size=(b, l, d)).astype(np.float32)
    items = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, n, size=(b, l))
    w = rng.uniform(0.0, 1.5, size=(b, l)).astype(np.float32)
    lse = np.asarray(jax.nn.logsumexp(jnp.einsum("bld,nd->bln", s, items), axis=-1))
    expected = jax_losses._ce_from_lse(*map(jnp.asarray, (s, items, y.astype(np.int32), w, lse)))
    got = losses._ce_from_lse(_t(s), _t(items), _t(y), _t(w), _t(lse))
    np.testing.assert_allclose(got.item(), float(expected), rtol=1e-5)
