"""Training losses for sequential transformers.

Port of rectools_tpu/models/nn/transformers/losses.py (reference
rectools/models/nn/transformers/lightning.py:144-212):

- softmax: CE over the full catalog, PAD target (id 0) ignored, weighted by
  yw, normalized by the count of contributing positions.
- BCE: positive at candidate index 0 against the negatives.
- gBCE: gSASRec calibration of the positive logit (arXiv 2308.07192), then BCE.
- sampled_softmax: positive swapped to index 1, CE with PAD ignored.

:func:`fused_softmax_loss` is the softmax loss without the (B, L, N) logits:
the forward is the streaming logsumexp (kernel 6, or 15 with
``ops.softmax_lse.USE_PARTIALS_FWD = False``) and its
``torch.autograd.Function`` carries the loss-level VJP of the JAX
``_fused_ce_fwd`` / ``_fused_ce_bwd`` — the lse cotangent ``c = g · w ·
[y != 0] / denom`` is folded into ``z = lse − log(c · |g|)`` and
``ops.softmax_lse.softmax_ce_grads_from_z`` takes the route the JAX package
takes: the fused gradient kernel (kernel 7) applies the label correction in
its tiles, and above its partials budget (catalogs over 81,920 items at
batch 512 × L 100 × d 128) the softmax gradients from z (kernels 13 + 14,
or 12) run without it and the label term follows in plain torch.
"""

import typing as tp

import torch

from ....ops.softmax_lse import softmax_ce_grads_from_z, streaming_lse


CountReduce = tp.Optional[tp.Callable[[torch.Tensor], torch.Tensor]]


def _denominator(count: torch.Tensor, count_reduce: CountReduce) -> torch.Tensor:
    """The count of contributing positions, at least 1. Under a process mesh a
    rank holds a shard of the batch: ``count_reduce`` sums the count over the
    shards, so each rank's value is its share of the one global loss and the
    shares add up to it."""
    if count_reduce is not None:
        count = count_reduce(count)
    return torch.clamp(count, min=1.0)


def softmax_loss(
    logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, count_reduce: CountReduce = None
) -> torch.Tensor:
    """CE over the catalog. logits (B, L, N); y (B, L) int targets; w (B, L) weights."""
    logprobs = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logprobs, -1, y[..., None])[..., 0]
    ce = torch.where(y == 0, torch.zeros_like(ce), ce)
    loss = ce * w
    n = (loss > 0).to(loss.dtype)
    return loss.sum() / _denominator(n.sum(), count_reduce)


def bce_loss(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, count_reduce: CountReduce = None) -> torch.Tensor:
    """BCE against 1 positive (index 0) + negatives. logits (B, L, 1 + n_neg)."""
    mask = (y != 0).to(logits.dtype)
    target = torch.zeros_like(logits)
    target[:, :, 0] = 1.0
    per_logit = torch.clamp(logits, min=0.0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    loss = per_logit.mean(dim=-1) * mask * w
    return loss.sum() / _denominator(mask.sum(), count_reduce)


def gbce_loss(
    logits: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    n_actual_items: int,
    n_negatives: int,
    gbce_t: float,
    count_reduce: CountReduce = None,
) -> torch.Tensor:
    """gBCE: reduce positive-logit overconfidence, then BCE."""
    alpha = n_negatives / (n_actual_items - 1)
    beta = alpha * (gbce_t * (1 - 1 / alpha) + 1 / alpha)
    pos_logits = logits[:, :, 0:1].float()
    neg_logits = logits[:, :, 1:].float()
    epsilon = 1e-10
    f32_max = torch.finfo(torch.float32).max
    pos_probs = torch.clamp(torch.sigmoid(pos_logits), epsilon, 1 - epsilon)
    pos_probs_adjusted = torch.clamp(pos_probs ** (-beta), 1 + epsilon, f32_max)
    pos_probs_adjusted = torch.clamp(1.0 / (pos_probs_adjusted - 1), epsilon, f32_max)
    calibrated = torch.cat([torch.log(pos_probs_adjusted), neg_logits], dim=-1)
    return bce_loss(calibrated, y, w, count_reduce)


def sampled_softmax_loss(
    logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, count_reduce: CountReduce = None
) -> torch.Tensor:
    """Sampled softmax: positive moved to class index 1 (index 0 = ignore)."""
    swapped = torch.cat([logits[:, :, 1:2], logits[:, :, 0:1], logits[:, :, 2:]], dim=-1)
    return softmax_loss(swapped, (y != 0).to(torch.int64), w, count_reduce)


def _ce_pieces(
    s2: torch.Tensor,
    items: torch.Tensor,
    y_flat: torch.Tensor,
    w_flat: torch.Tensor,
    lse: torch.Tensor,
    count_reduce: CountReduce = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Loss scalar + the per-position pieces both forward and backward need.
    The label logit is an f32 sum of f32 products, bf16 towers too (JAX
    ``preferred_element_type=float32``)."""
    logit_y = (s2.float() * items[y_flat].float()).sum(dim=-1)
    ce = torch.where(y_flat == 0, torch.zeros_like(lse), lse - logit_y)
    weighted = ce * w_flat
    denom = _denominator((weighted > 0).to(torch.float32).sum(), count_reduce)
    return weighted.sum() / denom, ce, denom


def _ce_from_lse(
    session_towers: torch.Tensor,
    item_towers: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    lse: torch.Tensor,
    count_reduce: CountReduce = None,
) -> torch.Tensor:
    """Softmax CE from a given (B, L) logsumexp, differentiated by autograd
    through ``lse`` and the target logits (the mesh route of the fused loss)."""
    d = session_towers.shape[-1]
    loss, _, _ = _ce_pieces(
        session_towers.reshape(-1, d), item_towers, y.reshape(-1), w.reshape(-1), lse.reshape(-1), count_reduce
    )
    return loss


class _FusedCE(torch.autograd.Function):
    """Softmax CE through the streaming lse with a loss-level VJP."""

    @staticmethod
    def forward(ctx, s2, items, y_flat, w_flat):  # type: ignore[override]
        lse = streaming_lse(s2, items)
        loss, ce, denom = _ce_pieces(s2, items, y_flat, w_flat, lse)
        ctx.save_for_backward(s2, items, y_flat, w_flat, lse, ce, denom)
        return loss

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        s2, items, y_flat, w_flat, lse, ce, denom = ctx.saved_tensors
        g = g.float()
        mask = (y_flat != 0).to(torch.float32)
        c = w_flat.float() * mask / denom  # per-row lse cotangent magnitude
        cg = c * g.abs()
        # c == 0 -> z = +inf -> that row's softmax gradients vanish
        z = lse - torch.log(cg)
        ds, di = softmax_ce_grads_from_z(s2, items, z, y_flat, cg)
        gsgn = torch.sign(g)
        dw = (g * ce / denom).to(w_flat.dtype)
        return (gsgn * ds).to(s2.dtype), (gsgn * di).to(items.dtype), None, dw


def fused_softmax_loss(
    session_towers: torch.Tensor,  # (B, L, D)
    item_towers: torch.Tensor,  # (N, D)
    y: torch.Tensor,  # (B, L)
    w: torch.Tensor,  # (B, L)
) -> torch.Tensor:
    """:func:`softmax_loss` of ``session_towers @ item_towersᵀ`` without the
    (B, L, N) logits. Sample weights ``w`` must be non-negative: the backward
    takes ``log(w · |g|)``, so a negative weight would give NaN gradients
    (``SequenceDataset.from_interactions`` enforces it for built-in data)."""
    b, length, d = session_towers.shape
    s2 = session_towers.reshape(b * length, d).contiguous()
    return _FusedCE.apply(s2, item_towers.contiguous(), y.reshape(-1), w.reshape(-1))


def requires_negatives(loss: str) -> tp.Optional[bool]:
    """Whether the loss trains on sampled negatives."""
    if loss == "softmax":
        return False
    if loss in ("BCE", "gBCE", "sampled_softmax"):
        return True
    return None
