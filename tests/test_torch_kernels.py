"""The port's hand-written CUDA kernels against their plain PyTorch twins, on
the card, plus the port's package-level guards.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch. The kernel tests are marked ``gpu`` and skip
without a card; on one, run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py``
(``--noconftest`` because tests/conftest.py configures JAX).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from rectools_tpu_torch.models import SASRecModel, TorchRanker
from rectools_tpu_torch.ops import _native, attention, layer_norm, topk, topk_select

REPO = Path(__file__).resolve().parents[1]
MASK_VALUE = -1e9


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_no_jax_and_nothing_of_the_jax_package() -> None:
    sources = sorted((REPO / "rectools_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = {}
    for path in sources:
        bad = {
            name for name in _imported_modules(path)
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "rectools_tpu")
        }
        if bad:
            offenders[str(path.relative_to(REPO))] = sorted(bad)
    assert not offenders, offenders


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    objects = np.ones((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        SASRecModel()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchRanker(topk.Distance.DOT, objects, objects)
    with pytest.raises(RuntimeError, match="cuda"):
        topk.TopKEngine(objects)


# ------------------------------------------------------------------ kernels on the card


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _causal_bias(l: int) -> np.ndarray:
    return np.where(np.tril(np.ones((l, l), dtype=bool)), 0.0, MASK_VALUE).astype(np.float32)[None, None]


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,eps", [(4099, 128, 1e-6), (33, 96, 1e-8), (7, 1024, 1e-6)])
def test_cuda_layer_norm_matches_twin(cuda: torch.device, m: int, d: int, eps: float) -> None:
    rng = np.random.default_rng(m)
    x = _t((rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)).to(cuda)
    g, b = (_t(rng.normal(size=(d,)).astype(np.float32)).to(cuda) for _ in range(2))
    before = _native.LAUNCHES["layer_norm_fwd"]
    got = layer_norm.layer_norm(x, g, b, eps)
    assert _native.LAUNCHES["layer_norm_fwd"] == before + 1
    torch.testing.assert_close(got, layer_norm.layer_norm_reference(x, g, b, eps), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bias_kind", ["none", "causal", "key_padding"])
@pytest.mark.parametrize("l,dh", [(100, 32), (12, 16), (257, 64)])
def test_cuda_attention_matches_twin(cuda: torch.device, bias_kind: str, l: int, dh: int) -> None:
    rng = np.random.default_rng(l)
    b, h = 3, 4
    q, k, v = (_t(rng.normal(size=(b, l, h, dh)).astype(np.float32)).to(cuda) for _ in range(3))  # (B, L, H, dh)
    bias = None
    if bias_kind == "causal":
        bias = _t(_causal_bias(l)).to(cuda)
    elif bias_kind == "key_padding":
        pad = np.arange(l)[None, :] < rng.integers(0, l, size=b)[:, None]
        kp = np.where(pad, MASK_VALUE, 0.0)[:, None, None, :] + _causal_bias(l)
        kp[:, :, np.arange(l), np.arange(l)] = 0.0
        bias = _t(kp.astype(np.float32)).to(cuda)
    scale = 1.0 / dh**0.5
    before = _native.LAUNCHES["attention_fwd"]
    out, lse = attention.attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, scale)
    assert _native.LAUNCHES["attention_fwd"] == before + 1
    assert out.transpose(1, 2).is_contiguous()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref_out, ref_lse = attention.attention_reference(qt, kt, vt, bias, scale)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_cuda_group_topm_matches_twin(cuda: torch.device) -> None:
    rng = np.random.default_rng(2)
    x = rng.normal(size=(9, 5 * 128)).astype(np.float32)
    x[:, [3, 40, 77, 127]] = 5.0  # ties inside a group: lowest lane first
    x[1, 128:256] = 1.0
    x[2, 256:384] = -np.inf  # all -inf: lane 0 every round on both sides
    x[4, 600:] = -np.inf
    xt = _t(x).to(cuda)
    before = _native.LAUNCHES["group_topm"]
    vals, lanes = topk_select.group_topm(xt, 12)
    assert _native.LAUNCHES["group_topm"] == before + 1
    ref_vals, ref_lanes = topk_select.group_topm_reference(xt, 12)
    torch.testing.assert_close(vals, ref_vals, atol=0, rtol=0)
    torch.testing.assert_close(lanes, ref_lanes, atol=0, rtol=0)
    # m > 32 parks results in lanes across several store runs
    vals, lanes = topk_select.group_topm(xt, 70)
    ref_vals, ref_lanes = topk_select.group_topm_reference(xt, 70)
    torch.testing.assert_close(vals, ref_vals, atol=0, rtol=0)
    torch.testing.assert_close(lanes, ref_lanes, atol=0, rtol=0)


@pytest.mark.gpu
def test_cuda_grouped_top_k_matches_cpu(cuda: torch.device) -> None:
    x = np.random.default_rng(3).normal(size=(64, 15872)).astype(np.float32)
    vals, idx = topk_select.grouped_exact_top_k(_t(x).to(cuda), 10)
    ref_vals, ref_idx = topk_select.grouped_exact_top_k(_t(x), 10)
    torch.testing.assert_close(vals.cpu(), ref_vals, atol=0, rtol=0)
    torch.testing.assert_close(idx.cpu(), ref_idx, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("adversarial", [False, True])
def test_cuda_rank_topk_matches_cpu(cuda: torch.device, adversarial: bool) -> None:
    from scipy import sparse

    rng = np.random.default_rng(7)
    n_subjects, n_objects, d, k = 300, 5000, 16, 20
    objects = rng.normal(size=(n_objects, d)).astype(np.float32)
    if adversarial:  # scores sorted along the catalog: group 0 holds the whole top k
        objects[:, 0] = np.linspace(100.0, 1.0, n_objects)
        objects[:, 1:] = 0.0
    subjects = np.abs(rng.normal(size=(n_subjects, d))).astype(np.float32) + 0.1
    seen = sparse.random(n_subjects, n_objects, density=0.01, format="csr", random_state=1)
    whitelist = np.sort(rng.choice(n_objects, size=4000, replace=False))
    kwargs = dict(k=k, filter_pairs_csr=seen, sorted_object_whitelist=whitelist, batch_size=128)
    got = topk.rank_topk(subjects, objects, np.arange(n_subjects), device=cuda, **kwargs)
    expected = topk.rank_topk(subjects, objects, np.arange(n_subjects), device="cpu", **kwargs)
    np.testing.assert_array_equal(got[0], expected[0])
    np.testing.assert_array_equal(got[1], expected[1])
    np.testing.assert_allclose(got[2], expected[2], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_cuda_sasrec_recommend_matches_cpu(cuda: torch.device) -> None:
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.models.nn.item_net import CatFeaturesItemNet, IdEmbeddingsItemNet

    rng = np.random.default_rng(9)
    n = 3000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 200, n),
        Columns.Item: rng.integers(0, 300, n),
        Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    })
    items = np.unique(df[Columns.Item])
    features = pd.DataFrame({"id": items, "feature": "genre", "value": rng.integers(0, 7, len(items))})
    dataset = Dataset.construct(df, item_features_df=features, cat_item_features=["genre"])
    config = dict(
        n_blocks=2, n_heads=4, n_factors=64, session_max_len=20, use_key_padding_mask=True,
        item_net_block_types=(IdEmbeddingsItemNet, CatFeaturesItemNet), recommend_batch_size=64,
    )
    models = {}
    for dev in ("cpu", "cuda"):
        model = SASRecModel(**config, device=dev)
        model._build_model_from_dataset(dataset)
        model.is_fitted = True
        models[dev] = model
    state = {
        name: _t(np.random.default_rng(len(name)).normal(scale=0.3, size=tuple(t.shape)).astype(np.float32))
        for name, t in models["cpu"].backbone.state_dict().items()
    }
    for model in models.values():
        model.backbone.load_state_dict(state)
    users = np.unique(df[Columns.User])
    got = models["cuda"].recommend(users, dataset, k=8, filter_viewed=True)
    expected = models["cpu"].recommend(users, dataset, k=8, filter_viewed=True)
    np.testing.assert_array_equal(got[Columns.User], expected[Columns.User])
    np.testing.assert_allclose(got[Columns.Score], expected[Columns.Score], rtol=1e-4, atol=1e-4)
    same = (got[Columns.Item].to_numpy() == expected[Columns.Item].to_numpy()).mean()
    assert same > 0.99  # only near-tied neighbours may swap

    targets = items[:50]
    got = models["cuda"].recommend_to_items(targets, dataset, k=8)
    expected = models["cpu"].recommend_to_items(targets, dataset, k=8)
    np.testing.assert_array_equal(got[Columns.TargetItem], expected[Columns.TargetItem])
    np.testing.assert_allclose(got[Columns.Score], expected[Columns.Score], rtol=1e-4, atol=1e-5)
    assert (got[Columns.Item].to_numpy() == expected[Columns.Item].to_numpy()).mean() > 0.99
