"""Training module — port of rectools_tpu/models/nn/transformers/training.py.

Holds the backbone (an ``nn.Module`` on the model's device), trains it and
serves u2i and i2i recommendations from it. A train step is forward, loss,
``backward`` and ``torch.optim.Adam`` (betas 0.9/0.98, eps 1e-8) in full f32;
on CUDA every LayerNorm, attention and softmax-CE goes through the port's
kernels and their ``autograd.Function``s. The rest follows the JAX module:
Xavier-normal init of every parameter with more than one dimension (Linear
biases from U(±1/√in)), the host rng contract (one
``np.random.default_rng(SeedSequence((seed, epochs_completed)))`` per fit
call, so batches equal the JAX package's), the fused softmax loss under the
same rule (``_use_fused_softmax``), validation loss at the last position
only, ``val_recall@k``, callbacks and loss histories.

Dropout salts come from a CPU ``torch.Generator`` that this module owns,
hands to the backbone's dropout and attention modules, and reseeds for every
step from ``(seed + 1, global_step)``, so a CPU and a CUDA run with the same
seed draw the same masks (see ``models/nn/dropout.py``).

Mesh training (``mesh_shape=(n_data, n_model)``). The JAX package is one
program over a device mesh and XLA places the collectives; here every rank of
a ``torch.distributed`` world of ``n_data · n_model`` processes runs this
module on the same dataset and seed, and the collectives are written out:

- a rank takes the batch rows of its data coordinate (``_local_batch``), and
  its dropout masks and device-drawn negatives are those rows of the global
  batch's (``dropout.set_batch_offset``), so a mesh fit follows the
  single-process fit up to summation order;
- the item tables are column-sharded over the model group (``item_net.py``);
- the full-catalog softmax loss row-shards the item tower over the model
  group (``ops.softmax_lse.sharded_streaming_lse``: kernel 8 forward, kernel 9
  or 10 + 11 backward), sums the session gradient and gathers the tower
  gradient over that group;
- there is one global loss: a rank's loss is its rows' sum over the global
  count of contributing positions (summed over the data group only: the ranks
  of a model group hold copies of the same rows), and parameter gradients are
  summed, not averaged, over the data group, in one flat buffer per step that
  also carries the loss value;
- train and validation losses and ``val_recall@k`` are global values, equal
  on every rank; ``get_state`` and the recommend paths see whole tables (they
  gather the column shards, so every rank must call them together).

Shared negatives (``negatives_sharing="batch"``): one (B, K) set of uniform
negatives per step, drawn with the counter hash over ``[n_extra_tokens,
n_items)`` as the positionwise ones are, shared by every position of a
session: the positive logits come from one row gather of the item tower, the
negative logits from one gather of B·K rows and a dense (B, L, K) product,
and the (B, L, 1 + K) logits go to the sampled losses.

Rematerialization (``remat=True``): in a train step the forward that feeds
the loss (the towers of the fused softmax, or the logits) runs under
``torch.utils.checkpoint`` and runs again in the backward instead of keeping
its activations. The dropout salts come from this module's generator, which
``checkpoint`` does not restore: :meth:`_rematerialized` gives the recompute
the generator state the forward started from, so it draws the same masks and
the gradients are those of the plain step. The recompute runs inside the
step's ``full_f32_matmul`` and with the same batch offsets.

Mixed precision (``compute_dtype="bfloat16"``, JAX ``training.py:303-338``,
``:400-405``): inside the train step's loss, and the validation loss, every
floating parameter is read as a bf16 copy made inside the autograd graph
(:meth:`_compute_params`), so the f32 master weights receive the gradients
through the casts and Adam stays f32. The stack then runs in bf16: the bf16
forms of the attention kernels (2, 5) or, in HSTU, of the STU kernels
(17-19), the bf16 forms of LayerNorm's kernels (1, 4: bf16 in and out, f32
inside, dγ and dβ rounded to bf16 once), bf16 linear layers accumulating in f32, the
embedding gather and its scatter-add in bf16 (one bf16 rounding per added
row, in index order, as XLA's scatter-add sums them). The fused loss applies
the temperature in f32 and rounds the towers to bf16 for the bf16 forms of
kernels 6 and 7, or under ``mesh_shape`` of the mesh loss's kernels 8 and 9
(10 + 11 above the partials budget), whose shards' session gradients are
rounded to bf16 and summed over the model group in bf16 (JAX's transpose of
the replicated input); the column-sharded tables' bf16 copies are gathered
over the model group. Every other logit is an f32 sum of bf16 products. The
validation recall and serving read the f32 weights, as in JAX. Every route
has a bf16 form; none runs in f32. The loss's bf16 forms take every width of
``SUPPORTED_D``, the models' default 256 among them.
``compute_dtype="auto"`` resolves to float32 here (JAX: bf16 on a TPU only;
a standing divergence, ROADMAP §3).
``steps_per_dispatch`` is validated for config compatibility and otherwise
unused: it never changes the trajectory in the JAX package, and the port
dispatches step by step.
"""

import contextlib
import copy
import typing as tp

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ....dataset.dataset import Dataset
from ....ops.softmax_lse import sharded_streaming_lse
from ....parallel import collectives
from ....parallel.distributed import data_parallel_row_range, global_batch_to_local
from ....parallel.mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh, make_mesh
from ....utils.device import full_f32_matmul, host_to_device
from ...base import InternalRecoTriplet
from ...rank import Distance, TorchRanker
from ..dropout import attach_generator, draw_key_words, hash_uniform_ints, set_batch_offset
from ..item_net import ItemNetBase
from .backbone import TransformerBackboneBase
from .data_preparator import Batch, BatchLoader, TransformerDataPreparatorBase
from .losses import (
    _ce_from_lse,
    bce_loss,
    fused_softmax_loss,
    gbce_loss,
    requires_negatives,
    sampled_softmax_loss,
    softmax_loss,
)
from .negative_sampler import CatalogUniformSampler
from .similarity import SimilarityModuleBase

if tp.TYPE_CHECKING:  # pragma: no cover
    from .callbacks import TrainingCallback


def _xavier_normal_reinit(backbone: TransformerBackboneBase, generator: torch.Generator) -> None:
    """Xavier-normal re-init of every parameter with more than one dimension
    (reference lightning.py:296-299); ``nn.Linear`` biases get torch's own
    default U(±1/√in_features), as the JAX package gives its Dense biases
    (rectools_tpu/models/nn/transformers/training.py:49-95). LayerNorm
    parameters stay as built; other vectors of the layer stack (HSTU's
    relative-bias tables) keep their own distribution and are redrawn by the
    stack's ``reinit_vectors``. Draws on the CPU ``generator`` in parameter
    order, so every device gets the same values."""
    with torch.no_grad():
        for param in backbone.parameters():
            if param.dim() > 1:
                fan_out, fan_in = param.shape[0], int(np.prod(param.shape[1:]))
                std = float(np.sqrt(2.0 / (fan_in + fan_out)))
                param.copy_(torch.randn(param.shape, generator=generator) * std)
        for module in backbone.modules():
            if isinstance(module, torch.nn.Linear) and module.bias is not None:
                bound = 1.0 / float(np.sqrt(module.weight.shape[1]))  # torch fan-in: weight is (out, in)
                module.bias.copy_(torch.rand(module.bias.shape, generator=generator) * (2 * bound) - bound)
        backbone.transformer_layers.reinit_vectors(generator)


_ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")  # the table-shaped entries of a parameter's Adam state


def _to_cpu(tree: tp.Any) -> tp.Any:
    """A deep copy of nested dicts / lists with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return copy.deepcopy(tree)


def pad_batch(batch: Batch, batch_size: int) -> Batch:
    """Zero-pad a batch to the static batch size (padded rows have y == 0 and
    yw == 0, so they never contribute to the loss)."""
    n = batch["x"].shape[0]
    if n == batch_size:
        return batch
    return {key: np.pad(arr, [(0, batch_size - n)] + [(0, 0)] * (arr.ndim - 1)) for key, arr in batch.items()}


def _stream_seed(*entropy: int) -> int:
    """A 63-bit generator seed derived from ``entropy`` (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


class TransformerTrainingModuleBase:
    """Base class for training modules; subclass and pass via
    ``training_module_type`` to change the training procedure."""

    def __init__(
        self,
        backbone: TransformerBackboneBase,
        device: torch.device,
        data_preparator: TransformerDataPreparatorBase,
        item_extra_tokens: tp.Sequence[tp.Any],
        lr: float = 0.001,
        gbce_t: float = 0.2,
        loss: str = "softmax",
        verbose: int = 0,
        train_loss_name: str = "train_loss",
        val_loss_name: str = "val_loss",
        adam_betas: tp.Tuple[float, float] = (0.9, 0.98),
        logits_t: float = 1,
        seed: int = 0,
        mesh_shape: tp.Optional[tp.Tuple[int, int]] = None,
        compute_dtype: str = "auto",
        negatives_on_device: bool = True,
        steps_per_dispatch: int = 8,
        fused_softmax_chunk: tp.Optional[int] = 2048,
        callbacks: tp.Optional[tp.Sequence["TrainingCallback"]] = None,
        val_recall_k: tp.Optional[int] = None,
        remat: bool = False,
        negatives_sharing: str = "positionwise",
        **kwargs: tp.Any,
    ) -> None:
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if negatives_sharing not in ("positionwise", "batch"):
            raise ValueError("negatives_sharing must be 'positionwise' or 'batch'")
        if compute_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'auto', 'float32' or 'bfloat16', got {compute_dtype}")
        if negatives_sharing == "batch" and not negatives_on_device:
            raise ValueError(
                "negatives_sharing='batch' draws its negatives on device; "
                "it requires negatives_on_device=True and the default CatalogUniformSampler"
            )
        self.compute_dtype = compute_dtype
        self.mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1])) if mesh_shape is not None else None
        self._mesh: tp.Optional[ProcessMesh] = None
        self._batch_offset = 0  # first row of the global batch this rank holds
        self.backbone = backbone.to(device).eval()
        self.device = device
        self.callbacks: tp.List["TrainingCallback"] = list(callbacks) if callbacks is not None else []
        self.val_recall_k = val_recall_k
        self.fused_softmax_chunk = fused_softmax_chunk
        self.negatives_on_device = negatives_on_device
        self.negatives_sharing = negatives_sharing
        self.remat = remat
        self.item_extra_tokens = item_extra_tokens
        self.data_preparator = data_preparator
        self.lr = lr
        self.loss = loss
        self.gbce_t = gbce_t
        self.adam_betas = adam_betas
        self.verbose = verbose
        self.train_loss_name = train_loss_name
        self.val_loss_name = val_loss_name
        self.logits_t = logits_t
        self.seed = seed

        self._requires_negatives = requires_negatives(loss)
        self.is_fitted = False
        self.optimizer: tp.Optional[torch.optim.Optimizer] = None
        self.epochs_completed = 0
        self.global_step = 0
        self.train_loss_history: tp.List[float] = []
        self.val_loss_history: tp.List[float] = []
        self.val_metric_history: tp.Dict[str, tp.List[float]] = {}
        self.dropout_generator = torch.Generator()
        attach_generator(self.backbone, self.dropout_generator)

    def fit(
        self,
        train_loader_factory: tp.Callable[[np.random.Generator], BatchLoader],
        val_loader_factory: tp.Callable[[np.random.Generator], tp.Optional[BatchLoader]],
        max_epochs: int,
    ) -> None:
        raise NotImplementedError()

    def recommend_u2i(self, *args: tp.Any, **kwargs: tp.Any) -> InternalRecoTriplet:
        raise NotImplementedError()

    def recommend_i2i(self, *args: tp.Any, **kwargs: tp.Any) -> InternalRecoTriplet:
        raise NotImplementedError()


class TransformerTrainingModule(TransformerTrainingModuleBase):
    """Default training module (reference lightning.py:259-449)."""

    i2i_dist = Distance.COSINE

    # ------------------------------------------------------------------- setup

    def _make_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(self.backbone.parameters(), lr=self.lr, betas=self.adam_betas, eps=1e-8)

    def _loss_fn(self, logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The loss of this rank's rows over the global count of contributing
        positions: the whole loss on one device, this rank's share under a mesh."""
        count_reduce = self._count_reduce
        if self.loss == "softmax":
            return softmax_loss(logits, y, w, count_reduce)
        if self.loss == "BCE":
            return bce_loss(logits, y, w, count_reduce)
        if self.loss == "gBCE":
            n_actual_items = self.backbone.item_model.n_items - len(self.item_extra_tokens)
            n_negatives = self.data_preparator.n_negatives
            if n_negatives is None:  # pragma: no cover
                raise ValueError("`n_negatives` is not defined. Please ensure that `n_negatives` is set.")
            return gbce_loss(logits, y, w, n_actual_items, n_negatives, self.gbce_t, count_reduce)
        if self.loss == "sampled_softmax":
            return sampled_softmax_loss(logits, y, w, count_reduce)
        return self._calc_custom_loss(logits, y, w)

    def _calc_custom_loss(self, logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        raise ValueError(f"loss {self.loss} is not supported")

    @property
    def _use_fused_softmax(self) -> bool:
        sim = self.backbone.similarity_module
        return (
            self.loss == "softmax"
            and self.fused_softmax_chunk is not None
            # single-chunk catalogs: the JAX package keeps the plain loss there
            and self.backbone.item_model.n_items > self.fused_softmax_chunk
            and type(sim).catalog_loss_towers is not SimilarityModuleBase.catalog_loss_towers
        )

    @property
    def resolved_compute_dtype(self) -> str:
        """The dtype ``compute_dtype`` resolves to: ``"auto"`` is float32 in the
        port (the JAX package picks bf16 on a TPU only; ROADMAP §3)."""
        return "float32" if self.compute_dtype == "auto" else self.compute_dtype

    @contextlib.contextmanager
    def _compute_params(self) -> tp.Iterator[None]:
        """Under bf16 compute, every floating parameter of the backbone reads
        as a bf16 copy made here, inside the autograd graph (one copy a
        parameter, however many modules share it); the parameters come back on
        exit. Gradients flow through the copies to the f32 parameters (JAX
        ``training.py:315-317``). Under float32 it does nothing."""
        if self.resolved_compute_dtype != "bfloat16":
            yield
            return
        copies: tp.Dict[int, torch.Tensor] = {}
        swapped = []
        for module in self.backbone.modules():
            for name, param in list(module._parameters.items()):
                if param is not None and param.is_floating_point():
                    swapped.append((module, name, param))
        try:
            for module, name, param in swapped:
                del module._parameters[name]
                setattr(module, name, copies.setdefault(id(param), param.to(torch.bfloat16)))
            yield
        finally:
            for module, name, param in swapped:
                module.__dict__.pop(name, None)
                module._parameters[name] = param

    @property
    def _use_device_negatives(self) -> bool:
        return (
            bool(self._requires_negatives)
            and self.negatives_on_device
            and type(self.data_preparator.negative_sampler) is CatalogUniformSampler
        )

    @property
    def _shares_negatives(self) -> bool:
        return self.negatives_sharing == "batch" and bool(self._requires_negatives)

    def _negatives(
        self, batch: tp.Dict[str, torch.Tensor], words: tp.Optional[tp.Sequence[int]]
    ) -> torch.Tensor:
        """The host's negatives, or uniform negatives over [n_extra_tokens,
        n_items) from the counter hash, as ``CatalogUniformSampler`` draws them
        on the host: (B, L, K), one set per position, or with shared negatives
        always one (B, K) set per session (JAX ``_batch_logits``, shared route)."""
        if "negatives" in batch and not self._shares_negatives:
            return batch["negatives"]
        if words is None:
            raise ValueError("negative key words are required when negatives are sampled on the device")
        b, length = batch["y"].shape
        k = self.data_preparator.n_negatives
        shape = (b, k) if self._shares_negatives else (b, length, k)
        return hash_uniform_ints(
            words, shape, len(self.item_extra_tokens), self.backbone.item_model.n_items, batch["y"].device,
            offset=self._batch_offset * int(np.prod(shape[1:])),
        )

    def _candidates(
        self, batch: tp.Dict[str, torch.Tensor], neg_words: tp.Optional[tp.Sequence[int]]
    ) -> torch.Tensor:
        return torch.cat([batch["y"][..., None], self._negatives(batch, neg_words)], dim=-1)

    def _shared_logits(
        self, session_embs: torch.Tensor, item_embs: torch.Tensor, y: torch.Tensor, negatives: torch.Tensor
    ) -> torch.Tensor:
        """(B, L, 1 + K) logits of the positives and of the session's shared
        negatives (B, K): the positives from one row gather of the item tower,
        the negatives from one gather of B·K rows and a dense (B, L, K) product."""
        s_t, i_t = self.backbone.similarity_module.catalog_loss_towers(session_embs, item_embs)
        # f32 sums of the products, from bf16 towers too (JAX `preferred_element_type=float32`)
        pos_logits = (s_t.float() * i_t[y].float()).sum(dim=-1, keepdim=True)
        neg_logits = torch.bmm(s_t.float(), i_t[negatives].float().transpose(1, 2))
        return torch.cat([pos_logits, neg_logits], dim=-1)

    def _rematerialized(self, fn: tp.Callable[..., tp.Any], *args: tp.Any) -> tp.Any:
        """``fn(*args)``; in training with ``remat``, under ``torch.utils.checkpoint``
        (non-reentrant), with the dropout generator set back to the state the
        forward started from while the backward recomputes ``fn``, so that the
        recompute draws the forward's salts, and restored after it."""
        if not (self.remat and self.backbone.training):
            return fn(*args)
        generator = self.dropout_generator
        start = generator.get_state()
        calls = 0

        def run(*run_args: tp.Any) -> tp.Any:
            nonlocal calls
            calls += 1
            if calls == 1:
                return fn(*run_args)
            resume = generator.get_state()
            generator.set_state(start)
            try:
                return fn(*run_args)
            finally:
                generator.set_state(resume)

        return checkpoint(run, *args, use_reentrant=False)

    def _batch_logits(
        self, batch: tp.Dict[str, torch.Tensor], neg_words: tp.Optional[tp.Sequence[int]] = None
    ) -> torch.Tensor:
        """Forward pass -> logits / logits_t (reference lightning.py:301-309)."""
        if self._shares_negatives:
            negatives = self._negatives(batch, neg_words)

            def shared(b: tp.Dict[str, torch.Tensor]) -> torch.Tensor:
                with self._compute_params():
                    item_embs = self.backbone.item_model.embed_catalog()
                    session_embs = self.backbone.encode_sessions(b, item_embs)
                    return self._shared_logits(session_embs, item_embs, b["y"], negatives)

            logits = self._rematerialized(shared, batch)
        else:
            candidates = self._candidates(batch, neg_words) if self._requires_negatives else None

            def forward(b: tp.Dict[str, torch.Tensor]) -> torch.Tensor:
                with self._compute_params():
                    return self.backbone(b, candidate_item_ids=candidates)

            logits = self._rematerialized(forward, batch)
        return logits.float() / self.logits_t

    def _fused_softmax_loss_value(self, batch: tp.Dict[str, torch.Tensor]) -> torch.Tensor:
        def towers(b: tp.Dict[str, torch.Tensor]) -> tp.Tuple[torch.Tensor, torch.Tensor]:
            with self._compute_params():
                item_embs = self.backbone.item_model.embed_catalog()
                session_embs = self.backbone.encode_sessions(b, item_embs)
                return self.backbone.similarity_module.catalog_loss_towers(session_embs, item_embs)

        s_t, i_t = self._rematerialized(towers, batch)
        s_t, i_t = s_t.float() / self.logits_t, i_t.float()
        if self.resolved_compute_dtype == "bfloat16":
            # the temperature in f32, then the towers stay bf16 into the loss kernels (JAX training.py:336-338)
            s_t, i_t = s_t.to(torch.bfloat16), i_t.to(torch.bfloat16)
        mesh = self._get_mesh()
        if mesh is None:
            return fused_softmax_loss(s_t, i_t, batch["y"], batch["yw"])
        # data x model form: the item tower row-sharded over the model group,
        # a streaming lse per shard, one (M,) merge; session rows stay with
        # their data coordinate
        b, length, d = s_t.shape
        lse = sharded_streaming_lse(s_t.reshape(b * length, d), i_t, mesh, MODEL_AXIS, data_axis=DATA_AXIS)
        return _ce_from_lse(s_t, i_t, batch["y"], batch["yw"], lse.reshape(b, length), self._count_reduce)

    def _device_batch(self, batch: Batch) -> tp.Dict[str, torch.Tensor]:
        return {k: host_to_device(v, self.device) for k, v in batch.items()}

    # ---------------------------------------------------------------- sharding

    def _get_mesh(self) -> tp.Optional[ProcessMesh]:
        if self.mesh_shape is None:
            return None
        if self._mesh is None:
            self._mesh = make_mesh(n_data=self.mesh_shape[0], n_model=self.mesh_shape[1])
        return self._mesh

    @property
    def _data_group(self) -> tp.Any:
        mesh = self._get_mesh()
        return None if mesh is None else mesh.group(DATA_AXIS)

    @property
    def _count_reduce(self) -> tp.Optional[tp.Callable[[torch.Tensor], torch.Tensor]]:
        group = self._data_group
        return None if group is None else lambda count: collectives.all_reduce_sum(count, group)

    def _shard_params(self) -> None:
        """Column-shard the item-vocabulary tables over the model group (see
        ``item_net.py``); everything else is replicated. The optimizer is made
        after this, so its state follows the shards."""
        mesh = self._get_mesh()
        if mesh is not None:
            for block in self.backbone.modules():
                if isinstance(block, ItemNetBase):
                    block.shard_columns(mesh)

    def _sharded_tables(self) -> tp.Iterator[tp.Tuple[str, ItemNetBase]]:
        """(state_dict key, block) of every column-sharded table."""
        for name, block in self.backbone.named_modules():
            if isinstance(block, ItemNetBase) and block.column_mesh is not None:
                yield f"{name}.{block.table_name}.weight", block

    @staticmethod
    def _whole_columns(local: torch.Tensor, block: ItemNetBase) -> torch.Tensor:
        """A table-shaped tensor's columns gathered over the model group."""
        return torch.cat(collectives.all_gather(local, block.column_mesh.group(MODEL_AXIS)), dim=1)

    @staticmethod
    def _local_columns(whole: torch.Tensor, block: ItemNetBase) -> torch.Tensor:
        """This rank's columns of a whole table-shaped tensor."""
        width = whole.shape[1] // block.column_mesh.size(MODEL_AXIS)
        start = block.column_mesh.index(MODEL_AXIS) * width
        return whole[:, start : start + width]

    def full_state_dict(self) -> tp.Dict[str, torch.Tensor]:
        """The backbone ``state_dict`` with whole tables: the column shards
        are gathered over the model group, so under a mesh with ``n_model > 1``
        every rank must call it together."""
        state = dict(self.backbone.state_dict())
        for key, block in self._sharded_tables():
            state[key] = self._whole_columns(state[key], block)
        return state

    def _map_table_moments(
        self, opt_state: tp.Dict[str, tp.Any], columns: tp.Callable[[torch.Tensor, ItemNetBase], torch.Tensor]
    ) -> tp.Dict[str, tp.Any]:
        """An optimizer ``state_dict`` with ``columns(moment, block)`` in place
        of the Adam moments of every column-sharded table. A table's entry is
        found by its parameter's index in the optimizer's groups, which
        ``state_dict`` numbers in order."""
        index = {id(p): i for i, p in enumerate(p for g in self.optimizer.param_groups for p in g["params"])}
        moments = dict(opt_state["state"])
        for _, block in self._sharded_tables():
            i = index[id(getattr(block, block.table_name).weight)]
            if i in moments:
                moments[i] = {
                    name: columns(value, block) if name in _ADAM_MOMENTS else value for name, value in moments[i].items()
                }
        return {**opt_state, "state": moments}

    def _local_batch(self, batch: Batch) -> Batch:
        """This rank's rows of a global host batch, and the matching offset for
        every mask-drawing module of the session encoder (the item tower's
        masks cover the whole catalog on every rank)."""
        mesh = self._get_mesh()
        if mesh is None:
            return batch
        start, _ = data_parallel_row_range(batch["x"].shape[0], mesh)
        if start != self._batch_offset:
            self._batch_offset = start
            set_batch_offset(self.backbone, start)
            set_batch_offset(self.backbone.item_model, 0)
        return global_batch_to_local(batch, mesh)

    def _sum_over_data_group(self, loss: torch.Tensor) -> torch.Tensor:
        """Sum every parameter gradient, and this rank's share of the loss,
        over the data group: one flat buffer, one all-reduce. A sum, not a
        mean: each share is already divided by the global count."""
        group = self._data_group
        if group is None:
            return loss.detach()
        grads = [p.grad for p in self.backbone.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        collectives.all_reduce_sum(flat, group)
        start = 0
        for g in grads:
            g.copy_(flat[start : start + g.numel()].view_as(g))
            start += g.numel()
        return flat[-1]

    def _train_step(self, batch: tp.Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step; returns the loss as a device scalar."""
        self.dropout_generator.manual_seed(_stream_seed(self.seed + 1, self.global_step))
        self.backbone.train()
        with full_f32_matmul():
            neg_words = draw_key_words(self.dropout_generator) if self._use_device_negatives else None
            if self._use_fused_softmax:
                loss = self._fused_softmax_loss_value(batch)
            else:
                loss = self._loss_fn(self._batch_logits(batch, neg_words), batch["y"], batch["yw"])
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = self._sum_over_data_group(loss)
            self.optimizer.step()
        self.global_step += 1
        return loss

    def _val_step(
        self,
        batch: tp.Dict[str, torch.Tensor],
        neg_words: tp.Optional[tp.Sequence[int]],
        recall_k: tp.Optional[int] = None,
    ) -> tp.Tuple[torch.Tensor, tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]]]:
        """Validation loss of the last position and, with ``recall_k``, the
        (hits, n_valid) of recall@k, from one encoding of the batch (two under
        bf16 compute: the loss reads the bf16 weights and the recall the f32
        ones, as JAX's ``_val_step`` and ``_val_recall_step`` do). The JAX
        ``_val_step`` slices the full logits to ``[:, -1:]``; the port computes
        only that slice."""
        with self._compute_params():
            item_embs = self.backbone.item_model.embed_catalog()
            session_embs = self.backbone.encode_sessions(batch, item_embs)[:, -1:, :]
            if self._shares_negatives:
                negatives = self._negatives(batch, neg_words)
                logits = self._shared_logits(session_embs, item_embs, batch["y"], negatives)
            else:
                candidates = self._candidates(batch, neg_words) if self._requires_negatives else None
                logits = self.backbone.similarity_module(session_embs, item_embs, candidates)
        logits = logits.float() / self.logits_t
        loss = self._loss_fn(logits, batch["y"], batch["yw"])
        if recall_k is None:
            return loss, None
        if self.resolved_compute_dtype == "bfloat16":
            item_embs = self.backbone.item_model.embed_catalog()
            session_embs = self.backbone.encode_sessions(batch, item_embs)[:, -1:, :]
        # recall@k of the held-out targets: last-position catalog scores,
        # extra tokens masked, padded rows excluded
        scores = self.backbone.similarity_module._get_full_catalog_logits(session_embs, item_embs)[:, 0, :]
        n_extra = len(self.item_extra_tokens)
        if n_extra:
            scores[:, :n_extra] = float("-inf")
        top = torch.topk(scores, min(recall_k, scores.shape[-1]), dim=-1).indices
        valid = batch["yw"][:, 0] > 0
        hits = (top == batch["y"][:, :1]).any(dim=1) & valid
        return loss, (hits.sum(), valid.sum())

    # -------------------------------------------------------------------- init

    def init_params(self) -> None:
        """Xavier-normal init from ``seed`` and a fresh optimizer (the port's
        parameter shapes, unlike flax's, need no sample batch)."""
        _xavier_normal_reinit(self.backbone, torch.Generator().manual_seed(self.seed))
        self._shard_params()
        self.optimizer = self._make_optimizer()

    def load_params(self, state_dict: tp.Mapping[str, torch.Tensor]) -> None:
        """Start training from given parameters (a backbone ``state_dict``, e.g.
        from ``flax_params_to_state_dict``) with a fresh optimizer. Under a
        mesh the tables come whole and each rank keeps its columns."""
        self._shard_params()
        state_dict = dict(state_dict)
        for key, block in self._sharded_tables():
            state_dict[key] = self._local_columns(state_dict[key], block)
        self.backbone.load_state_dict(state_dict, strict=True)
        self.optimizer = self._make_optimizer()

    # --------------------------------------------------------------------- fit

    def fit(
        self,
        train_loader_factory: tp.Callable[[np.random.Generator], BatchLoader],
        val_loader_factory: tp.Callable[[np.random.Generator], tp.Optional[BatchLoader]],
        max_epochs: int,
    ) -> None:
        """Epoch loop. Loaders come from factories so each fit / fit_partial
        call re-derives its host rng stream from the seed and epoch counter."""
        if self._shares_negatives:
            if not self._use_device_negatives:
                raise ValueError(
                    "negatives_sharing='batch' requires device-drawn negatives "
                    "(negatives_on_device=True with the default CatalogUniformSampler)"
                )
            sim = self.backbone.similarity_module
            if type(sim).catalog_loss_towers is SimilarityModuleBase.catalog_loss_towers:
                raise ValueError(
                    "negatives_sharing='batch' computes its logits from similarity_module.catalog_loss_towers, "
                    f"which {type(sim).__name__} does not override — use negatives_sharing='positionwise' or "
                    "implement catalog_loss_towers"
                )
        self.data_preparator.host_negatives = not self._use_device_negatives
        host_rng = np.random.default_rng(np.random.SeedSequence(entropy=(self.seed, self.epochs_completed)))
        train_loader = train_loader_factory(host_rng)
        val_loader = val_loader_factory(host_rng)
        if self.optimizer is None:
            self.init_params()

        for callback in self.callbacks:
            callback.on_train_start(self)
        for _ in range(max_epochs):
            logs: tp.Dict[str, float] = {}
            # losses stay on the device until the epoch closes: no sync per step
            epoch_losses = [
                self._train_step(self._device_batch(self._local_batch(pad_batch(batch, train_loader.batch_size))))
                for batch in train_loader
            ]
            if epoch_losses:
                self.train_loss_history.append(float(torch.stack(epoch_losses).mean()))
                logs[self.train_loss_name] = self.train_loss_history[-1]
            if val_loader is not None:
                self._validate(val_loader, logs)
            self.epochs_completed += 1
            if self.verbose > 0:
                print(f"epoch {self.epochs_completed}: " + " ".join(f"{n}={v:.5f}" for n, v in logs.items()))
            # every callback sees every epoch (no short-circuit)
            stop = [callback.on_epoch_end(self, self.epochs_completed, logs) for callback in self.callbacks]
            if any(stop):
                break
        for callback in self.callbacks:
            callback.on_train_end(self)
        self.backbone.eval()
        self.is_fitted = True

    def _validate(self, val_loader: BatchLoader, logs: tp.Dict[str, float]) -> None:
        self.backbone.eval()
        losses, hits, totals = [], [], []
        with torch.no_grad(), full_f32_matmul():
            for vi, batch in enumerate(val_loader):
                batch = self._local_batch(pad_batch(batch, val_loader.batch_size))
                neg_words = None
                if self._requires_negatives and "negatives" not in batch:
                    neg_words = draw_key_words(torch.Generator().manual_seed(_stream_seed(self.seed + 3, vi)))
                loss, recall = self._val_step(self._device_batch(batch), neg_words, self.val_recall_k)
                losses.append(loss)
                if recall is not None:
                    hits.append(recall[0])
                    totals.append(recall[1])
        # under a mesh: the ranks' shares of each batch's loss, and their hit
        # and row counts, summed over the data group
        group = self._data_group
        if losses:
            self.val_loss_history.append(float(collectives.all_reduce_sum(torch.stack(losses), group).mean()))
            logs[self.val_loss_name] = self.val_loss_history[-1]
        counts = None
        if totals:
            counts = torch.stack([torch.stack(hits).sum(), torch.stack(totals).sum()])
            counts = collectives.all_reduce_sum(counts, group)
        recall_total = float(counts[1]) if counts is not None else 0.0
        if self.val_recall_k is not None and recall_total > 0:
            name = f"val_recall@{self.val_recall_k}"
            value = float(counts[0]) / recall_total
            self.val_metric_history.setdefault(name, []).append(value)
            logs[name] = value

    # --------------------------------------------------------------- inference

    def _encode_last(self, batch: tp.Dict[str, torch.Tensor], item_embs: torch.Tensor) -> torch.Tensor:
        """Session-tower output of the last position for each session. The
        whole batch goes in: time-aware layers read its ``unix_ts``."""
        session_embs = self.backbone.encode_sessions(batch, item_embs)
        return self.backbone.similarity_module.session_tower_forward(session_embs[:, -1, :])

    def _catalog_item_embs(self) -> torch.Tensor:
        return self.backbone.item_model.embed_catalog()

    def _catalog_item_tower(self, item_embs: torch.Tensor) -> torch.Tensor:
        return self.backbone.similarity_module.item_tower_forward(item_embs)

    def _get_user_item_embeddings(self, recommend_loader: BatchLoader) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """User (last-position) and item tower outputs, device-resident: every
        batch is dispatched before anything comes back to the host, and the
        ranker consumes the tensors where they are."""
        item_embs = self._catalog_item_embs()
        user_embs = [self._encode_last(self._device_batch(batch), item_embs) for batch in recommend_loader]
        return torch.cat(user_embs, dim=0), self._catalog_item_tower(item_embs)

    def recommend_u2i(
        self,
        user_ids: np.ndarray,
        recommend_loader: BatchLoader,
        sorted_item_ids_to_recommend: np.ndarray,
        k: int,
        dataset: Dataset,
        filter_viewed: bool,
    ) -> InternalRecoTriplet:
        """U2I: batch-encode sessions then rank on the top-k engine
        (reference lightning.py:402-426)."""
        ui_csr_for_filter = None
        if filter_viewed:
            ui_csr_for_filter = dataset.get_user_item_matrix(include_weights=False, include_warm_items=True)[user_ids]
        self.backbone.eval()
        with torch.inference_mode(), full_f32_matmul():
            user_embs, item_embs = self._get_user_item_embeddings(recommend_loader)
            return self.backbone.similarity_module.recommend_u2i(
                user_embs=user_embs,
                item_embs=item_embs,
                user_ids=np.asarray(user_ids),
                k=k,
                sorted_item_ids_to_recommend=sorted_item_ids_to_recommend,
                ui_csr_for_filter=ui_csr_for_filter,
            )

    def recommend_i2i(
        self,
        target_ids: np.ndarray,
        sorted_item_ids_to_recommend: np.ndarray,
        k: int,
    ) -> InternalRecoTriplet:
        """I2I: cosine ranking over raw item-net embeddings
        (reference lightning.py:428-449)."""
        self.backbone.eval()
        with torch.inference_mode(), full_f32_matmul():
            item_embs = self._catalog_item_embs()
            ranker = TorchRanker(
                distance=self.i2i_dist, subjects_factors=item_embs, objects_factors=item_embs, device=self.device
            )
            return ranker.rank(
                subject_ids=target_ids,
                k=k,
                filter_pairs_csr=None,
                sorted_object_whitelist=sorted_item_ids_to_recommend,
            )

    # ------------------------------------------------------------------- state

    def get_state(self) -> tp.Dict[str, tp.Any]:
        """Checkpoint payload (JAX ``training.py:916-945``): the backbone's
        parameters and the optimizer's ``state_dict``, both with whole tables,
        the epoch and step counters and the loss and metric histories, every
        tensor a CPU copy. Under a mesh every rank calls it together."""
        return {
            "params": {k: v.detach().cpu().clone() for k, v in self.full_state_dict().items()},
            "opt_state": (
                _to_cpu(self._map_table_moments(self.optimizer.state_dict(), self._whole_columns))
                if self.optimizer is not None
                else None
            ),
            "epochs_completed": self.epochs_completed,
            "global_step": self.global_step,
            "train_loss_history": list(self.train_loss_history),
            "val_loss_history": list(self.val_loss_history),
            "val_metric_history": {name: list(vals) for name, vals in self.val_metric_history.items()},
            "is_fitted": self.is_fitted,
        }

    def set_state(self, state: tp.Dict[str, tp.Any], sample_batch: tp.Optional[Batch] = None) -> None:
        """Restore a :meth:`get_state` payload onto this module's device
        (``load_state_dict`` moves the optimizer state to its parameters).
        Under a mesh each rank keeps its columns of the whole tables and of
        their Adam moments, so a payload saved on any mesh, or in one process,
        loads on any other; ``sample_batch`` is unused: the parameter shapes
        need no batch."""
        self.load_params(state["params"])
        if state["opt_state"] is not None:
            self.optimizer.load_state_dict(self._map_table_moments(state["opt_state"], self._local_columns))
        self.epochs_completed = state["epochs_completed"]
        self.global_step = state["global_step"]
        self.train_loss_history = list(state["train_loss_history"])
        self.val_loss_history = list(state["val_loss_history"])
        self.val_metric_history = {name: list(vals) for name, vals in state.get("val_metric_history", {}).items()}
        self.is_fitted = state["is_fitted"]
