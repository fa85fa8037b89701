"""BPR matrix factorization trained with minibatch SGD on the device.

Port of rectools_tpu/ops/bpr.py (replaces implicit's Hogwild Cython/CUDA BPR,
consumed by the reference at rectools/models/implicit_bpr.py:222-226). Same
objective — maximize sigmoid(<p_u, q_i> + b_i - <p_u, q_j> - b_j) over
sampled (u, pos, neg) triplets with L2 regularization — in synchronous
minibatches. JAX's ``lax.scan`` over the batches of an epoch becomes a Python
loop of device work with no host sync: every update of a step is computed
from the step's old parameters (JAX's chained ``.at[].add``), and duplicate
rows sum through ``index_put_(..., accumulate=True)``, which sorts its
indices (stably) and sums each row's updates in order: the same bits on a
rerun, where ``index_add_``'s float atomics would not give them.

Negative verification (implicit's `verify_negative_samples`) is one
``torch.searchsorted`` over the int64 keys u * n_items + i of the CSR, which
the CSR (indices sorted per row) already orders: accidental positives get
their update masked to zero.

Draws: JAX draws the epoch's permutation and negatives from PRNG keys, which
a ``torch.Generator`` cannot replay. ``bpr_fit`` takes them from a ``draw``
function: by default ``generator_draws`` (a generator on the device seeded
with ``random_state``, 0 when None, at every fit); tests pass JAX's own
``permutation`` / ``randint`` blocks. The initial factors are the JAX
package's numpy draws.
"""

import typing as tp

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, host_to_device, resolve_device

# draw(epoch, nnz, n_batches, batch_size) -> (permutation of nnz (nnz,), negatives (n_batches, batch_size))
EpochDraw = tp.Callable[[int, int, int, int], tp.Tuple[torch.Tensor, torch.Tensor]]


class BPRParams(tp.NamedTuple):
    user_emb: torch.Tensor  # (n_users, f)
    item_emb: torch.Tensor  # (n_items, f)
    item_bias: torch.Tensor  # (n_items,)


def generator_draws(generator: torch.Generator, n_items: int) -> EpochDraw:
    """Each epoch's permutation and uniform negatives in [0, n_items) from
    ``generator``, on its device."""

    def draw(epoch: int, nnz: int, n_batches: int, batch_size: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        perm = torch.randperm(nnz, generator=generator, device=generator.device)
        negs = torch.randint(0, n_items, (n_batches, batch_size), generator=generator, device=generator.device)
        return perm, negs

    return draw


def _csr_contains(keys: torch.Tensor, n_items: int, u: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Vectorized membership test: is (u, j) among the CSR's (sorted) int64
    keys u * n_items + i?"""
    query = u * n_items + j
    pos = torch.searchsorted(keys, query).clamp_max(keys.shape[0] - 1)
    return keys[pos] == query


def _bpr_epoch(
    params: BPRParams,
    perm: torch.Tensor,  # (nnz,) int64
    negs: torch.Tensor,  # (n_batches, batch_size) int64
    users: torch.Tensor,  # (nnz,) int64 — one entry per interaction
    items: torch.Tensor,  # (nnz,) int64
    keys: torch.Tensor,  # (nnz,) int64 sorted u * n_items + i
    n_items: int,
    lr: float,
    reg: float,
    verify_negatives: bool,
    batch_size: int,
) -> None:
    """One epoch in place on ``params``: all interactions in ``perm``'s
    order, batched SGD (JAX's count of correctly ordered triplets, which its
    fit drops, is not kept)."""
    nnz = users.shape[0]
    n_batches = max(1, nnz // batch_size)
    usable = n_batches * batch_size
    # Wrap around if nnz is not a batch multiple (a few resampled duplicates).
    perm = torch.cat([perm, perm[: max(0, usable - nnz)]])[:usable]
    u_ep = users[perm].view(n_batches, batch_size)
    i_ep = items[perm].view(n_batches, batch_size)
    user_emb, item_emb, item_bias = params
    for step in range(n_batches):
        u, i, j = u_ep[step], i_ep[step], negs[step]
        pu, qi, qj = user_emb[u], item_emb[i], item_emb[j]
        bi, bj = item_bias[i], item_bias[j]
        x_uij = torch.sum(pu * (qi - qj), dim=1) + bi - bj
        z = torch.sigmoid(-x_uij)  # gradient weight
        if verify_negatives:
            w = (~_csr_contains(keys, n_items, u, j)).to(torch.float32)
        else:
            w = torch.ones_like(z)
        zw, w2 = (z * w)[:, None], w[:, None]
        du = zw * (qi - qj) - reg * pu * w2
        dqi = zw * pu - reg * qi * w2
        dqj = -zw * pu - reg * qj * w2
        dbi = (z - reg * bi) * w
        dbj = (-z - reg * bj) * w
        ij = torch.cat([i, j])
        user_emb.index_put_((u,), lr * du, accumulate=True)
        item_emb.index_put_((ij,), torch.cat([lr * dqi, lr * dqj]), accumulate=True)
        item_bias.index_put_((ij,), torch.cat([lr * dbi, lr * dbj]), accumulate=True)


def bpr_fit(
    ui_csr: sparse.csr_matrix,
    factors: int,
    learning_rate: float,
    regularization: float,
    iterations: int,
    random_state: tp.Optional[int],
    verify_negative_samples: bool = True,
    batch_size: int = 8192,
    initial: tp.Optional[tp.Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    device: DeviceLike = "cuda",
    draw: tp.Optional[EpochDraw] = None,
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train BPR on ``device``; returns (user_emb, item_emb, item_bias) on the host."""
    dev = resolve_device(device)
    n_users, n_items = ui_csr.shape
    ui_csr = ui_csr.tocsr()
    ui_csr.sort_indices()
    coo = ui_csr.tocoo()
    users = host_to_device(coo.row.astype(np.int64), dev)
    items = host_to_device(coo.col.astype(np.int64), dev)
    keys = host_to_device(coo.row.astype(np.int64) * n_items + coo.col.astype(np.int64), dev)

    rng = np.random.RandomState(random_state)
    if initial is not None:
        host = initial
    else:
        # Same init scale convention as implicit: normal / factors.
        host = (
            rng.normal(size=(n_users, factors)).astype(np.float32) / factors,
            rng.normal(size=(n_items, factors)).astype(np.float32) / factors,
            np.zeros((n_items,), dtype=np.float32),
        )
    params = BPRParams(*(host_to_device(np.array(a, dtype=np.float32), dev) for a in host))
    # Small datasets: one batch must not exceed the interaction count, or the
    # epoch's wrap-around padding (built from a single permutation copy)
    # cannot fill it.
    nnz = len(coo.row)
    batch_size = max(1, min(batch_size, nnz))
    n_batches = max(1, nnz // batch_size)
    if draw is None:
        generator = torch.Generator(device=dev).manual_seed(random_state if random_state is not None else 0)
        draw = generator_draws(generator, n_items)
    for epoch in range(iterations):
        perm, negs = draw(epoch, nnz, n_batches, batch_size)
        _bpr_epoch(params, perm.to(dev, torch.int64), negs.to(dev, torch.int64), users, items, keys, n_items,
                   float(learning_rate), float(regularization), verify_negative_samples, batch_size)
    return tuple(t.cpu().numpy() for t in params)  # type: ignore[return-value]
