"""Hybrid matrix factorization on the device: feature-summed embeddings +
biases trained with logistic / BPR / WARP losses.

Port of rectools_tpu/ops/hybrid_mf.py (replaces the LightFM Cython SGD the
reference wraps, rectools/models/lightfm.py:93-320). One minibatch step:
gather user/item feature rows from padded index tables, sum feature
embeddings, score, and an Adagrad / Adadelta update. WARP's sequential
"sample until violation" loop is a parallel draw of ``max_sampled``
negatives per positive with the first violator selected by argmax — the rank
weight log((n_items-1)/trials) is preserved.

The gradients come from autograd and are dense over the whole tables, as
JAX's are: Adadelta decays its squared-gradient average on rows a step did
not touch, so a sparse update would drift from JAX. The optimizers are
written by hand to optax's formulas (``make_optimizer``): optax's Adagrad puts
eps inside the root and gives 0 where the sum is 0, where
``torch.optim.Adagrad`` adds eps after the root.

The negatives of a step are an argument of ``train_step``: the model draws
them from a ``torch.Generator`` (``negative_draws``), where JAX draws them
from a PRNG key inside its step; tests pass JAX's draws.
"""

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
from scipy import sparse

from ..utils.device import full_f32_matmul

Params = tp.Dict[str, torch.Tensor]
OptState = tp.Dict[str, Params]
# draw(step, batch_size) -> (batch_size, max_sampled) int64 item ids
NegativeDraw = tp.Callable[[int, int], torch.Tensor]
LEARNING_SCHEDULES = ("adagrad", "adadelta")
# optax's accumulator start for Adagrad (its 0.1 default damps early updates
# an order of magnitude for minibatch training); LightFM's starts at ~0
ADAGRAD_INITIAL_ACCUMULATOR = 1e-10


def pad_feature_table(csr: sparse.csr_matrix) -> tp.Tuple[np.ndarray, np.ndarray]:
    """CSR feature matrix -> padded (n_rows, max_nnz) index + value tables.

    Row representations then compute as ``sum_j emb[idx[r, j]] * val[r, j]``
    with zero-valued padding entries contributing nothing.
    """
    n_rows = csr.shape[0]
    lengths = np.diff(csr.indptr)
    max_len = max(int(lengths.max()) if n_rows else 0, 1)
    idx = np.zeros((n_rows, max_len), dtype=np.int32)
    val = np.zeros((n_rows, max_len), dtype=np.float32)
    if lengths.sum() > 0:
        rows = np.repeat(np.arange(n_rows), lengths)
        cols = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
        idx[rows, cols] = csr.indices
        val[rows, cols] = csr.data
    return idx, val


def _repr_of(
    emb: torch.Tensor, bias: torch.Tensor, feat_idx: torch.Tensor, feat_val: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Feature-summed representation: (..., P) indices -> (..., d) embedding + scalar bias.

    The gathers are ``F.embedding``s: a batch repeats a feature row tens of
    thousands of times (a genre in every positive and negative), and the
    backward of an indexing accumulates each row's duplicates in one serial
    run (5.3 ms a call at the KION width on an H100 80GB HBM3), where the
    embedding backward sums them in parallel partial segments; both repeat
    their bits."""
    vecs = F.embedding(feat_idx, emb) * feat_val[..., None]  # (..., P, d)
    b = F.embedding(feat_idx, bias[:, None])[..., 0] * feat_val  # (..., P)
    return vecs.sum(dim=-2), b.sum(dim=-1)


class Optimizer(tp.NamedTuple):
    """LightFM's learning schedules as optax computes them: ``adagrad``
    (optax ``scale_by_rss``, accumulator from 1e-10) or ``adadelta`` (optax
    ``scale_by_adadelta``), each followed by the step of -learning_rate."""

    schedule: str
    learning_rate: float
    rho: float
    epsilon: float

    def init(self, params: Params) -> OptState:
        if self.schedule == "adagrad":
            return {"sum_of_squares": {k: torch.full_like(v, ADAGRAD_INITIAL_ACCUMULATOR) for k, v in params.items()}}
        return {"e_g": {k: torch.zeros_like(v) for k, v in params.items()},
                "e_x": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, params: Params, grads: Params, state: OptState) -> tp.Tuple[Params, OptState]:
        new_params: Params = {}
        if self.schedule == "adagrad":
            sums: Params = {}
            for k, g in grads.items():
                s = g * g + state["sum_of_squares"][k]
                scaled = torch.where(s > 0, torch.rsqrt(s + self.epsilon), 0.0) * g
                new_params[k] = params[k] + scaled * -self.learning_rate
                sums[k] = s
            return new_params, {"sum_of_squares": sums}
        e_g_all, e_x_all = {}, {}
        for k, g in grads.items():
            e_g = (1 - self.rho) * g**2 + self.rho * state["e_g"][k]
            scaled = torch.sqrt(state["e_x"][k] + self.epsilon) / torch.sqrt(e_g + self.epsilon) * g
            e_x_all[k] = (1 - self.rho) * scaled**2 + self.rho * state["e_x"][k]
            e_g_all[k] = e_g
            new_params[k] = params[k] + scaled * -self.learning_rate
        return new_params, {"e_g": e_g_all, "e_x": e_x_all}


def make_optimizer(learning_schedule: str, learning_rate: float, rho: float, epsilon: float) -> Optimizer:
    """LightFM's learning schedules: adagrad (default) or adadelta."""
    if learning_schedule not in LEARNING_SCHEDULES:
        raise ValueError(f"Unknown learning_schedule: {learning_schedule}")
    return Optimizer(learning_schedule, float(learning_rate), float(rho), float(epsilon))


def _loss(
    p: Params,
    user_feat_idx: torch.Tensor,
    user_feat_val: torch.Tensor,
    item_feat_idx: torch.Tensor,
    item_feat_val: torch.Tensor,
    pos_items: torch.Tensor,
    weights: torch.Tensor,
    neg_items: tp.Optional[torch.Tensor],
    loss: str,
    n_items: int,
    user_alpha: float,
    item_alpha: float,
    kos_k: int,
) -> torch.Tensor:
    u_vec, u_b = _repr_of(p["user_emb"], p["user_bias"], user_feat_idx, user_feat_val)
    if loss == "warp-kos":
        # k-th order statistic positive (Weston et al. k-OS WARP; LightFM
        # `loss="warp-kos"` with its k/n params): score the n sampled
        # positives per user and train on the k-th best-scoring one.
        cand_vec, cand_b = _repr_of(p["item_emb"], p["item_bias"], item_feat_idx[pos_items], item_feat_val[pos_items])
        cand_score = torch.einsum("bd,bnd->bn", u_vec, cand_vec) + u_b[:, None] + cand_b
        order = torch.argsort(-cand_score, dim=1, stable=True)  # descending
        kth = order[:, min(kos_k, pos_items.shape[1]) - 1]  # (B,)
        rows = torch.arange(kth.shape[0], device=kth.device)
        pos_vec, pos_score = cand_vec[rows, kth], cand_score[rows, kth]
    else:
        pos_vec, pos_b = _repr_of(p["item_emb"], p["item_bias"], item_feat_idx[pos_items], item_feat_val[pos_items])
        pos_score = torch.sum(u_vec * pos_vec, dim=-1) + u_b + pos_b  # (B,)
    n_valid = torch.clamp_min(torch.sum((weights != 0).to(torch.float32)), 1.0)
    zero = torch.zeros_like(pos_score)

    if loss == "logistic":
        # observed interactions: label = sign(weight), magnitude = |weight|
        y01 = (torch.sign(weights) + 1.0) / 2.0
        per = torch.maximum(pos_score, zero) - pos_score * y01 + torch.log1p(torch.exp(-torch.abs(pos_score)))
    else:
        if neg_items is None:
            raise ValueError(f"loss {loss!r} needs the step's negatives")
        neg_vec, neg_b = _repr_of(p["item_emb"], p["item_bias"], item_feat_idx[neg_items], item_feat_val[neg_items])
        neg_score = torch.einsum("bd,bmd->bm", u_vec, neg_vec) + u_b[:, None] + neg_b  # (B, M)
        if loss == "bpr":
            # first sampled negative (LightFM BPR uses a single draw)
            per = torch.log1p(torch.exp(-(pos_score - neg_score[:, 0])))
        else:  # warp / warp-kos (same rank loss, different positive)
            # violation: margin rank loss triggered when 1 - s_pos + s_neg > 0
            violations = neg_score > pos_score[:, None] - 1.0
            first = torch.argmax(violations.to(torch.int32), dim=1)  # first violating draw
            # rank estimate: floor((n_items - 1) / trials); weight log(rank)
            rank_w = torch.log(torch.clamp_min(torch.floor((n_items - 1) / (first + 1)), 1.0))
            chosen_neg = torch.gather(neg_score, 1, first[:, None])[:, 0]
            hinge = torch.maximum(1.0 - pos_score + chosen_neg, zero)
            per = rank_w * hinge * violations.any(dim=1).to(torch.float32)
    data_loss = torch.sum(per * torch.abs(weights)) / n_valid
    reg = user_alpha * torch.sum(u_vec * u_vec) + item_alpha * torch.sum(pos_vec * pos_vec)
    return data_loss + reg / n_valid


def train_step(
    params: Params,
    opt_state: OptState,
    user_feat_idx: torch.Tensor,  # (B, Pu)
    user_feat_val: torch.Tensor,
    item_feat_idx: torch.Tensor,  # (n_items, Pi) full table
    item_feat_val: torch.Tensor,
    pos_items: torch.Tensor,  # (B,) int64; for warp-kos: (B, n) sampled positives
    weights: torch.Tensor,  # (B,) float (sample weight; 0 => padded row)
    neg_items: tp.Optional[torch.Tensor],  # (B, max_sampled) int64; None for logistic
    loss: str,
    n_items: int,
    optimizer: Optimizer,
    user_alpha: float = 0.0,
    item_alpha: float = 0.0,
    kos_k: int = 5,
) -> tp.Tuple[Params, OptState, torch.Tensor]:
    """One minibatch SGD step. Padded rows (weight 0) contribute nothing."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with full_f32_matmul():
        loss_val = _loss(leaves, user_feat_idx, user_feat_val, item_feat_idx, item_feat_val, pos_items, weights,
                         neg_items, loss, n_items, user_alpha, item_alpha, kos_k)
    grads = dict(zip(leaves, torch.autograd.grad(loss_val, list(leaves.values()))))
    with torch.no_grad():
        new_params, new_state = optimizer.update(params, grads, opt_state)
    return new_params, new_state, loss_val.detach()


def init_params(
    n_user_features: int, n_item_features: int, no_components: int, generator: torch.Generator
) -> Params:
    """LightFM-style init: uniform(-1, 1)/no_components embeddings, zero biases
    (lightfm's _initialize), drawn from ``generator`` on its device."""
    scale = 1.0 / no_components
    dev = generator.device

    def uniform(rows: int) -> torch.Tensor:
        return torch.empty((rows, no_components), dtype=torch.float32, device=dev).uniform_(
            -scale, scale, generator=generator)

    user_emb = uniform(n_user_features)
    item_emb = uniform(n_item_features)
    return {
        "user_emb": user_emb,
        "user_bias": torch.zeros((n_user_features,), dtype=torch.float32, device=dev),
        "item_emb": item_emb,
        "item_bias": torch.zeros((n_item_features,), dtype=torch.float32, device=dev),
    }


def negative_draws(generator: torch.Generator, n_items: int, max_sampled: int) -> NegativeDraw:
    """Each step's uniform negatives in [0, n_items) from ``generator``, on its device."""

    def draw(step: int, batch_size: int) -> torch.Tensor:
        return torch.randint(0, n_items, (batch_size, max_sampled), generator=generator, device=generator.device)

    return draw
