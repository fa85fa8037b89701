"""The port's ``ops/linalg.py`` and ``ops/topk.py`` random ranking, held
against the JAX package's on the CPU, from seeded numpy CSR matrices.

Tolerances: the Gram on the host branch bit-equal (the same scipy product);
on the device branch within 1e-5 of its largest entry (f32 sums in another
order). SPD inverses and EASE weights within 1e-5 of the largest entry, of
JAX's and of the float64 inverse. Eigenvalues within 1e-4 relative,
eigenvectors within 1e-4 of |cos| = 1, SVD reconstructions within 1e-4 of
the largest entry; the subspace path starts from JAX's own
``jax.random.normal`` block (``q0``); on a Gram too skewed for JAX's f32
Cholesky QR (NaN there) the port's eigenvalues within 1e-5 of the largest of
the float64 ones. Random ranking on JAX's own uniform
draws: identical items and scores.
"""

import math
import typing as tp

import numpy as np
import pytest
import torch
from scipy import sparse

from rectools_tpu_torch.ops import linalg
from rectools_tpu_torch.ops.topk import random_rank_topk, uniform_draws

# name: (n_users, n_items, block_rows); n_users > 4 n_items takes the host branch
GRAM_CASES = {"host_scipy": (400, 60, 8192), "device_one_block": (120, 300, 8192), "device_blocks": (120, 300, 32)}
# name: (n_items, factors, solver, maxiter)
EIGH_CASES = {
    "exact": (80, 5, "exact", None),
    "auto_small": (80, 5, "auto", None),
    "subspace": (300, 10, "iterative", None),
    "auto_maxiter": (300, 10, "auto", 60),
}
# name: (n_objects, n_subjects, k, filter, whitelist)
RANDOM_CASES = {
    "plain": (300, 21, 10, False, None),
    "seen": (300, 21, 10, True, None),
    "whitelist": (300, 21, 10, False, 130),
    "seen_whitelist": (300, 21, 10, True, 130),
    "full_groups": (256, 21, 10, True, None),  # JAX pads to 256 columns, the port to 384 (one spare)
    "short_whitelist": (300, 9, 10, True, 5),  # seen rows leave fewer than k: a masked tail of ties
}
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: the iterative solvers run hundreds of
    small ops, and with other test workers holding the cores each parallel
    region waits for its slowest thread, which turns seconds into minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _csr(n_users: int, n_items: int, seed: int, density: float = 0.08, weights: bool = True) -> sparse.csr_matrix:
    rng = np.random.default_rng(seed)
    m = sparse.random(n_users, n_items, density=density, random_state=rng, format="csr", dtype=np.float32)
    m.data = (rng.uniform(0.5, 3.0, m.nnz) if weights else rng.integers(1, 4, m.nnz)).astype(np.float32)
    return m


def _regularized_gram(n: int) -> np.ndarray:
    return linalg.gram_matrix(_csr(3 * n, n, n), device="cpu").numpy() + np.float32(50.0) * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("case", sorted(GRAM_CASES))
def test_gram_matrix_matches_jax(case: str) -> None:
    from rectools_tpu.ops import linalg as jax_linalg

    n_users, n_items, block_rows = GRAM_CASES[case]
    x = _csr(n_users, n_items, n_users + n_items)
    expected = np.asarray(jax_linalg.gram_matrix(x, block_rows=block_rows))
    got = linalg.gram_matrix(x, block_rows=block_rows, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n_items, n_items)
    if case == "host_scipy":
        np.testing.assert_array_equal(got.numpy(), expected)
    else:
        np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-5 * np.abs(expected).max())


@pytest.mark.parametrize("solver", ["exact", "iterative", "auto"])
@pytest.mark.parametrize("n", [64, 300])
def test_spd_inverse_matches_jax(n: int, solver: str) -> None:
    import jax.numpy as jnp

    from rectools_tpu.ops import linalg as jax_linalg

    g = _regularized_gram(n)
    expected = np.asarray(jax_linalg.spd_inverse(jnp.asarray(g), solver=solver))
    got = linalg.spd_inverse(torch.tensor(g), solver=solver).numpy()
    exact = np.linalg.inv(g.astype(np.float64))
    scale = np.abs(exact).max()
    assert np.abs(got - expected).max() <= 1e-5 * scale
    assert np.abs(got - exact).max() <= 1e-5 * scale


@pytest.mark.parametrize("solver", ["exact", "iterative", "auto"])
@pytest.mark.parametrize("n", [64, 300])
def test_ease_weight_matches_jax(n: int, solver: str) -> None:
    from rectools_tpu.ops import linalg as jax_linalg

    x = _csr(3 * n, n, n + 1)
    expected = jax_linalg.ease_weight(x, 50.0, solver=solver)
    got = linalg.ease_weight(x, 50.0, solver=solver, device="cpu")
    assert got.dtype == np.float32 and not np.diag(got).any()
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5 * np.abs(expected).max())


def _start_block(n: int, factors: int, seed: int) -> np.ndarray:
    """JAX's starting block of the subspace iteration (``_subspace_topk_eigh``)."""
    import jax
    import jax.numpy as jnp

    k = min(factors + int(min(max(16, factors // 2), n - factors)), n)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, k), dtype=jnp.float32))


@pytest.mark.parametrize("case", sorted(EIGH_CASES))
def test_topk_eigh_and_truncated_svd_match_jax(case: str) -> None:
    import jax.numpy as jnp

    from rectools_tpu.ops import linalg as jax_linalg

    n, factors, solver, maxiter = EIGH_CASES[case]
    x = _csr(2 * n, n, n + 2)
    q0 = torch.tensor(_start_block(n, factors, 3))
    gram = linalg.gram_matrix(x, device="cpu")
    ev, vec = jax_linalg.topk_eigh(jnp.asarray(gram.numpy()), factors, maxiter=maxiter, seed=3, solver=solver)
    got_ev, got_vec = linalg.topk_eigh(gram, factors, maxiter=maxiter, seed=3, solver=solver, q0=q0)
    ev, vec, got_ev, got_vec = (np.asarray(a) for a in (ev, vec, got_ev, got_vec))
    np.testing.assert_allclose(got_ev, ev, rtol=1e-4)
    assert np.all(np.diff(got_ev) <= 0)
    np.testing.assert_allclose(np.abs((got_vec * vec).sum(axis=0)), 1.0, atol=1e-4)

    users, items = jax_linalg.truncated_svd(x, factors, maxiter=maxiter, random_state=3, solver=solver)
    got_users, got_items = linalg.truncated_svd(x, factors, maxiter=maxiter, random_state=3, solver=solver,
                                                device="cpu", q0=q0)
    assert got_users.dtype == got_items.dtype == np.float32
    assert got_users.shape == (2 * n, factors) and got_items.shape == (n, factors)
    recon, got_recon = users @ items.T, got_users @ got_items.T
    np.testing.assert_allclose(got_recon, recon, rtol=0, atol=1e-4 * np.abs(recon).max())


def test_subspace_topk_eigh_survives_a_skewed_gram() -> None:
    """One item in every user's row with weight 40: the Gram's condition is
    ~4e3, past where JAX's shifted Cholesky QR holds in f32 (its eigenvalues
    come out NaN, a reference fault); the port's Householder QR gives the
    float64 eigenvalues within 1e-5 of the largest."""
    import jax.numpy as jnp

    from rectools_tpu.ops import linalg as jax_linalg

    x = _csr(600, 300, 9, density=0.05).tolil()
    x[:, 0] = 40.0
    gram = linalg.gram_matrix(x.tocsr(), device="cpu")
    q0 = torch.tensor(_start_block(300, 20, 3))
    jax_ev, _ = jax_linalg.topk_eigh(jnp.asarray(gram.numpy()), 20, seed=3, solver="iterative")
    assert not np.isfinite(np.asarray(jax_ev)).all()
    ev, vec = linalg.topk_eigh(gram, 20, solver="iterative", q0=q0)
    exact = np.linalg.eigvalsh(gram.numpy().astype(np.float64))[::-1][:20]
    assert exact[0] / exact[-1] > 3e3
    np.testing.assert_allclose(ev.numpy(), exact, rtol=0, atol=1e-5 * exact[0])
    np.testing.assert_allclose(vec.T.numpy() @ vec.numpy(), np.eye(20), atol=1e-5)


def test_topk_eigh_draws_its_start_from_the_seed() -> None:
    gram = linalg.gram_matrix(_csr(600, 300, 5), device="cpu")
    first = linalg.topk_eigh(gram, 10, seed=4, solver="iterative")
    again = linalg.topk_eigh(gram, 10, seed=4, solver="iterative")
    exact = linalg.topk_eigh(gram, 10, solver="exact")
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    np.testing.assert_allclose(first[0].numpy(), exact[0].numpy(), rtol=1e-4)


def _jax_draws(key: tp.Any, n_subjects: int, n_candidates: int) -> tp.Callable[[int, tp.Tuple[int, int]], torch.Tensor]:
    """A ``draw`` for the port's ``random_rank_topk`` that gives JAX's uniform
    block of batch ``bi`` (``jax.random.uniform(keys[bi], (b_pad, n_pad))``,
    its first b rows), in the port's width. ``draw.calls`` lists the batches
    drawn, in order (a batch drawn again was sorted exactly)."""
    import jax
    import jax.numpy as jnp

    from rectools_tpu.ops import topk as jax_topk

    keys = jax.random.split(key, max(math.ceil(n_subjects / BATCH), 1))
    n_pad = max(128, math.ceil(n_candidates / 128) * 128)

    def draw(bi: int, shape: tp.Tuple[int, int]) -> torch.Tensor:
        draw.calls.append(bi)
        b = shape[0]
        block = np.asarray(jax.random.uniform(keys[bi], (jax_topk._next_pow2(b, minimum=8), n_pad), dtype=jnp.float32))
        out = np.ones(shape, dtype=np.float32)  # the columns past JAX's are masked
        width = min(shape[1], n_pad)
        out[:, :width] = block[:b, :width]
        return torch.from_numpy(out)

    draw.calls = []
    return draw


@pytest.mark.parametrize("case", sorted(RANDOM_CASES))
def test_random_rank_topk_on_jax_draws_matches_jax(case: str) -> None:
    import jax

    from rectools_tpu.ops import topk as jax_topk

    n_objects, n_subjects, k, seen, whitelist_size = RANDOM_CASES[case]
    rng = np.random.default_rng(n_objects + n_subjects + k)
    subjects = rng.permutation(40)[:n_subjects]
    csr = _csr(n_subjects, n_objects, 11, density=0.3) if seen else None
    whitelist = None if whitelist_size is None else np.sort(rng.choice(n_objects, whitelist_size, replace=False))
    key = jax.random.PRNGKey(7)
    expected = jax_topk.random_rank_topk(key, n_objects, subjects, k, csr, whitelist, batch_size=BATCH)
    n_candidates = n_objects if whitelist is None else len(whitelist)
    draw = _jax_draws(key, n_subjects, n_candidates)
    got = random_rank_topk(draw, n_objects, subjects, k, csr, whitelist, batch_size=BATCH, device="cpu")
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g, e)
    n_batches = math.ceil(n_subjects / BATCH)
    assert draw.calls[:n_batches] == list(range(n_batches))
    assert draw.calls == list(range(n_batches))  # k <= m: no batch fails the certificate or is drawn again
    assert got[0].dtype == got[1].dtype == np.int64 and got[2].dtype == np.float32
    if seen:
        seen_pairs = {(subjects[r], c) for r, c in zip(*csr.nonzero())}
        assert not seen_pairs & set(zip(got[0].tolist(), got[1].tolist()))


def test_uniform_draws_give_a_batch_its_block_again() -> None:
    """The redraw a failed certificate asks for is the first draw's block;
    other batches, and a fresh generator's next call, get other blocks."""
    generator = torch.Generator().manual_seed(1)
    draw = uniform_draws(generator)
    first, second = draw(0, (4, 256)), draw(1, (4, 256))
    assert torch.equal(draw(0, (4, 256)), first) and torch.equal(draw(1, (4, 256)), second)
    assert not torch.equal(first, second)
    assert not torch.equal(uniform_draws(generator)(0, (4, 256)), first)  # the generator moved on
    assert float(first.min()) >= 0.0 and float(first.max()) < 1.0


@pytest.mark.parametrize("call", ["spd_inverse", "topk_eigh", "ease_weight", "truncated_svd"])
def test_unknown_solver_is_refused(call: str) -> None:
    x = _csr(40, 20, 1)
    g = torch.tensor(_regularized_gram(20))
    calls = {
        "spd_inverse": lambda: linalg.spd_inverse(g, solver="lapack"),
        "topk_eigh": lambda: linalg.topk_eigh(g, 3, solver="lapack"),
        "ease_weight": lambda: linalg.ease_weight(x, 10.0, solver="lapack", device="cpu"),
        "truncated_svd": lambda: linalg.truncated_svd(x, 3, solver="lapack", device="cpu"),
    }
    with pytest.raises(ValueError, match="solver must be one of"):
        calls[call]()
