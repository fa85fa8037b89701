"""The port's ``TopKEngine.query_batch`` and ANN recommenders
(``rectools_tpu_torch/tools/ann.py``) held against the JAX package's on the
CPU.

Inputs are dyadic (multiples of 1/8; COSINE objects are sign vectors of norm
2), so every dot product, normalisation and ranking score is exact in f32 in
both packages and ties are exact ties. Tolerances:
- items, validity flags and their order: identical (ties lowest index
  first, as JAX's ``lax.top_k`` and its two-level reduction order them);
- reported scores: within 1e-6 relative and 1e-6 absolute (COSINE divides
  by the subject's norm, EUCLIDEAN takes a square root, each package its
  own way);
- the ANN recommenders' lists: identical.
"""

import pickle
import typing as tp

import numpy as np
import pytest
import torch

import rectools_tpu_torch.tools as port_tools
from rectools_tpu_torch.dataset import IdMap
from rectools_tpu_torch.ops import topk, topk_select
from rectools_tpu_torch.ops.topk import Distance, TopKEngine
from rectools_tpu_torch.tools import ItemToItemAnnRecommender, UserToItemAnnRecommender

SCORE_RTOL = SCORE_ATOL = 1e-6
DISTANCES = ("DOT", "COSINE", "EUCLIDEAN")


def _jax_engine(objects: np.ndarray, distance: str, **kwargs: tp.Any) -> tp.Any:
    from rectools_tpu.ops.topk import Distance as JaxDistance, TopKEngine as JaxEngine

    return JaxEngine(objects, distance=JaxDistance[distance], **kwargs)


def _objects(rng: np.random.Generator, n: int, d: int, distance: str, duplicates: bool = True) -> np.ndarray:
    """Dyadic object vectors; a third of them copies of others (exact ties)."""
    if distance == "COSINE":  # four entries of ±1: norm 2, so normalising is exact
        objects = np.zeros((n, d), np.float32)
        cols = np.argsort(rng.random((n, d)), axis=1)[:, :4]
        np.put_along_axis(objects, cols, rng.choice([-1.0, 1.0], size=(n, 4)).astype(np.float32), axis=1)
    else:
        objects = (rng.integers(-16, 17, size=(n, d)) / 8).astype(np.float32)
    if duplicates:
        dst = rng.choice(n, size=n // 3, replace=False)
        objects[dst] = objects[rng.choice(n, size=n // 3)]
    return objects


def _subjects(rng: np.random.Generator, b: int, d: int) -> np.ndarray:
    return (rng.integers(-16, 17, size=(b, d)) / 8).astype(np.float32)


def _seen(rng: np.random.Generator, b: int, n: int, width: int = 7) -> np.ndarray:
    """Per-row seen lists padded with ids >= n (JAX's convention); every
    other row sees nothing."""
    seen = rng.integers(0, n, size=(b, width))
    seen[::2] = n + 3
    seen[1::4, width // 2 :] = n
    return seen.astype(np.int32)


def _assert_same_query(got: tp.Tuple[np.ndarray, ...], ref: tp.Tuple[np.ndarray, ...]) -> None:
    idx, scores, valid = got
    ref_idx, ref_scores, ref_valid = (np.asarray(x) for x in ref)
    assert idx.shape == ref_idx.shape and idx.dtype == ref_idx.dtype
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(np.where(valid, idx, -1), np.where(ref_valid, ref_idx, -1))
    np.testing.assert_allclose(scores[valid], ref_scores[ref_valid], rtol=SCORE_RTOL, atol=SCORE_ATOL)


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("distance", DISTANCES)
@pytest.mark.parametrize("b", [1, 4095, 4096, 4097])
def test_query_batch_matches_jax(distance: str, b: int) -> None:
    """Row batches of 4,096 against JAX's one-shot scoring: same items, in
    the same tie order, past the masked seen ids; k = 60 over 300 objects."""
    rng = np.random.default_rng(b)
    n, d, k = 300, 16, 60
    objects, subjects = _objects(rng, n, d, distance), _subjects(rng, b, d)
    seen = _seen(rng, b, n)
    engine = TopKEngine(objects, distance=Distance[distance], batch_size=4096, device="cpu")
    got = engine.query_batch(subjects, k, seen)
    assert got[0].shape == (b, k)
    _assert_same_query(got, _jax_engine(objects, distance, batch_size=4096).query_batch(subjects, k, seen))
    _assert_same_query(engine.query_batch(subjects, k), _jax_engine(objects, distance).query_batch(subjects, k))


@pytest.mark.parametrize("distance", DISTANCES)
def test_query_batch_matches_jax_on_wide_catalog_ties(distance: str) -> None:
    """5,000 objects in 40 groups, heavy ties (entries in {-1, 0, 1}): JAX
    takes its two-level reduction there (chunk-major, lowest index first);
    k = 100 > m, so batches may be suspect and sorted again."""
    rng = np.random.default_rng(5)
    n, d, b, k = 5000, 8, 300, 100
    objects = rng.integers(-1, 2, size=(n, d)).astype(np.float32)
    if distance == "COSINE":
        objects = _objects(rng, n, d, distance)
    subjects = rng.integers(-1, 2, size=(b, d)).astype(np.float32)
    seen = _seen(rng, b, n, width=40)
    engine = TopKEngine(objects, distance=Distance[distance], batch_size=128, device="cpu")
    ref = _jax_engine(objects, distance).query_batch(subjects, k, seen)
    _assert_same_query(engine.query_batch(subjects, k, seen), ref)


def test_query_batch_recomputes_a_suspect_batch_and_counts_it(monkeypatch: pytest.MonkeyPatch) -> None:
    """Every object the same vector: all scores tie. With m forced to 1 each
    group keeps one candidate, so the certificate fails on every batch; the
    batch is sorted again (lowest ids first, JAX's order) and counted."""
    monkeypatch.setattr(topk_select, "DEFAULT_M", 1)
    rng = np.random.default_rng(3)
    n, d, b, k = 1000, 8, 4097, 30
    objects = np.tile(_subjects(rng, 1, d), (n, 1))
    subjects = _subjects(rng, b, d)
    engine = TopKEngine(objects, batch_size=4096, device="cpu")
    scores = torch.from_numpy(subjects[:8] @ objects.T)
    padded = torch.nn.functional.pad(scores, (0, engine._objects_t.shape[1] - n), value=topk.NEG_INF)
    _, fast_idx, suspect = topk_select.grouped_top_k_candidates(padded, k)
    assert bool(suspect) and not np.array_equal(fast_idx.numpy()[0], np.arange(k))  # the fast path alone is wrong
    before = dict(topk_select.FALLBACKS)
    got = engine.query_batch(subjects, k)
    assert topk_select.FALLBACKS["query_batch"] - before.get("query_batch", 0) == 2  # both batches
    assert topk_select.FALLBACKS["rank_topk"] == before.get("rank_topk", 0)
    np.testing.assert_array_equal(got[0], np.tile(np.arange(k, dtype=np.int32), (b, 1)))
    _assert_same_query(got, _jax_engine(objects, "DOT").query_batch(subjects, k))


@pytest.mark.parametrize("distance", DISTANCES)
def test_approximate_is_served_exactly_as_jax_serves_it_on_the_cpu(distance: str) -> None:
    """``approximate=True``: JAX's ``approx_max_k`` path (exact off the TPU)
    and the port's exact route give the same lists at a loose recall target;
    the flags are kept."""
    rng = np.random.default_rng(11)
    objects, subjects = _objects(rng, 2000, 16, distance), _subjects(rng, 64, 16)
    kwargs = dict(approximate=True, recall_target=0.5)
    engine = TopKEngine(objects, distance=Distance[distance], device="cpu", **kwargs)
    assert engine.approximate is True and engine.recall_target == 0.5 and engine.batch_size == 4096
    got = engine.query_batch(subjects, 20)
    _assert_same_query(got, _jax_engine(objects, distance, **kwargs).query_batch(subjects, 20))
    exact = TopKEngine(objects, distance=Distance[distance], device="cpu").query_batch(subjects, 20)
    for a, e in zip(got, exact):
        np.testing.assert_array_equal(a, e)


def test_query_batch_edge_shapes() -> None:
    objects = np.eye(5, 4, dtype=np.float32)
    engine = TopKEngine(objects, device="cpu")
    idx, scores, valid = engine.query_batch(np.zeros((0, 4), np.float32), 3)
    assert idx.shape == scores.shape == valid.shape == (0, 3) and idx.dtype == np.int32
    idx, _, valid = engine.query_batch(np.ones((2, 4), np.float32), 10)  # k above the catalog: 5 columns
    assert idx.shape == (2, 5) and valid.all()
    idx, _, valid = engine.query_batch(np.ones((1, 4), np.float32), 5, np.array([[0, 1, 2, 3, 4]]))
    assert not valid.any()  # everything seen


def _rank_topk_before(subjects, objects, subject_ids, k, distance, filter_pairs_csr, sorted_object_whitelist,
                      batch_size):
    """``rank_topk``'s own loop as it stood before it shared ``query_batch``'s."""
    from scipy import sparse

    object_block = objects if sorted_object_whitelist is None else objects[sorted_object_whitelist]
    engine = TopKEngine(object_block, distance=distance, device="cpu")
    pending = []
    for start in range(0, len(subject_ids), batch_size):
        batch_pos = np.arange(start, min(start + batch_size, len(subject_ids)))
        batch_subject_ids = subject_ids[batch_pos]
        if sparse.issparse(subjects):
            sub_block = np.asarray(subjects[batch_subject_ids].todense(), dtype=np.float32)
        else:
            sub_block = np.asarray(subjects[batch_subject_ids], dtype=np.float32)
        seen = None
        if filter_pairs_csr is not None:
            seen = topk._seen_columns(filter_pairs_csr, batch_pos, sorted_object_whitelist, engine.fill)
        pending.append((batch_subject_ids, sub_block, seen, engine.query_batch_async(sub_block, k, seen)))
    idx_all, scores_all, valid_all, suspect = topk._fetch([p[3] for p in pending])
    offsets = np.concatenate(([0], np.cumsum([len(p[0]) for p in pending])))
    n_suspect = int(suspect.sum())
    for bi in np.flatnonzero(suspect):
        _, sub_block, seen, _ = pending[bi]
        idx_b, scores_b, valid_b, _ = topk._fetch([engine.query_batch_async(sub_block, k, seen, exact=True)])
        lo, hi = offsets[bi], offsets[bi + 1]
        idx_all[lo:hi], scores_all[lo:hi], valid_all[lo:hi] = idx_b, scores_b, valid_b
    flat_valid = valid_all.ravel()
    flat_idx = idx_all.ravel()[flat_valid]
    all_subj = np.concatenate([p[0] for p in pending]).astype(np.int64)
    subj_rep = np.repeat(all_subj, valid_all.sum(axis=1))
    obj_ids = (flat_idx if sorted_object_whitelist is None else sorted_object_whitelist[flat_idx]).astype(np.int64)
    return (subj_rep, obj_ids, scores_all.ravel()[flat_valid].astype(np.float32)), n_suspect


@pytest.mark.parametrize("case", ["dense", "sparse_whitelist", "ties"])
def test_rank_topk_bit_equal_to_its_loop_before_sharing_it(case: str) -> None:
    from scipy import sparse

    rng = np.random.default_rng(len(case))
    n_subj, n_obj, d = 700, 900, 8
    objects = _objects(rng, n_obj, d, "DOT")
    subjects: tp.Any = _subjects(rng, n_subj, d)
    whitelist = None
    if case == "sparse_whitelist":
        subjects = sparse.random(n_subj, n_obj, density=0.02, format="csr", random_state=2, dtype=np.float32)
        objects = rng.normal(size=(n_obj, n_obj)).astype(np.float32)
        whitelist = np.sort(rng.choice(n_obj, 600, replace=False))
    if case == "ties":
        objects = rng.integers(-1, 2, size=(n_obj, d)).astype(np.float32)
        subjects = rng.integers(-1, 2, size=(n_subj, d)).astype(np.float32)
    seen_csr = sparse.random(n_subj, n_obj, density=0.03, format="csr", random_state=4)
    subject_ids = rng.permutation(n_subj)[:650]
    args = (subjects, objects, subject_ids, 40, Distance.DOT, seen_csr[subject_ids], whitelist, 256)
    before_counts = dict(topk_select.FALLBACKS)
    got = topk.rank_topk(*args, device="cpu")
    counted = topk_select.FALLBACKS["rank_topk"] - before_counts.get("rank_topk", 0)
    ref, n_suspect = _rank_topk_before(*args)
    for a, e in zip(got, ref):
        assert a.dtype == e.dtype
        np.testing.assert_array_equal(a, e)
    assert counted == n_suspect
    if case == "ties":
        assert n_suspect > 0  # the shared loop's recompute is exercised


# ------------------------------------------------------------- recommenders


def _vectors() -> tp.Tuple[np.ndarray, np.ndarray, tp.Any, tp.Any]:
    """tests/tools/test_ann.py's vectors; the id maps built in each package."""
    rng = np.random.default_rng(0)
    item_vectors = rng.normal(size=(20, 8)).astype(np.float32)
    user_vectors = rng.normal(size=(10, 8)).astype(np.float32)
    return user_vectors, item_vectors, [f"u{i}" for i in range(10)], [f"i{i}" for i in range(20)]


def _pair(kind: str, *args: tp.Any, maps: tp.Sequence[tp.Any] = (), **kwargs: tp.Any) -> tp.Tuple[tp.Any, tp.Any]:
    """(the port's recommender, the JAX package's) built from the same
    vectors; ``maps`` are external id lists (or dicts) turned into each
    package's IdMap."""
    import rectools_tpu.tools as jax_tools
    from rectools_tpu.dataset import IdMap as JaxIdMap
    from rectools_tpu.models import Distance as JaxDistance

    def id_maps(cls: tp.Any) -> tp.List[tp.Any]:
        return [m if isinstance(m, dict) else cls.from_values(m) for m in maps]

    jax_kwargs = dict(kwargs)
    if "distance" in kwargs:
        jax_kwargs["distance"] = JaxDistance[kwargs["distance"].name]
    port = getattr(port_tools, kind)(*args, *id_maps(IdMap), device="cpu", **kwargs)
    ref = getattr(jax_tools, kind)(*args, *id_maps(JaxIdMap), **jax_kwargs)
    return port.fit(), ref.fit()


def _same_lists(got: tp.Any, ref: tp.Any) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


U2I = "UserToItemAnnRecommender"
I2I = "ItemToItemAnnRecommender"


class TestUserToItemAnnRecommender:
    def test_matches_brute_force(self) -> None:
        users, items, umap, imap = _vectors()
        port, ref = _pair(U2I, users, items, maps=[umap, imap])
        got = port.get_item_list_for_user("u0", top_n=5)
        norms = np.linalg.norm(items, axis=1) * np.linalg.norm(users[0])
        expected = np.argsort(-(items @ users[0] / norms))[:5]
        np.testing.assert_array_equal(got, np.asarray(imap)[expected])
        _same_lists([got], [ref.get_item_list_for_user("u0", top_n=5)])

    def test_batch_with_whitelists(self) -> None:
        users, items, umap, imap = _vectors()
        port, ref = _pair(U2I, users, items, maps=[umap, imap], index_top_k=20)
        whitelists = [["i0", "i1", "i2"], ["i3", "i4"]]
        got = port.get_item_list_for_user_batch(["u0", "u1"], top_n=2, item_ids=whitelists)
        assert set(got[0]) <= {"i0", "i1", "i2"} and set(got[1]) <= {"i3", "i4"}
        _same_lists(got, ref.get_item_list_for_user_batch(["u0", "u1"], top_n=2, item_ids=whitelists))

    def test_pickling(self) -> None:
        users, items, umap, imap = _vectors()
        port, ref = _pair(U2I, users, items, maps=[umap, imap])
        restored = pickle.loads(pickle.dumps(port))
        assert restored._engine is None and restored.device == "cpu"
        got = restored.get_item_list_for_user("u3", top_n=4)
        _same_lists([got], [port.get_item_list_for_user("u3", top_n=4)])
        _same_lists([got], [ref.get_item_list_for_user("u3", top_n=4)])
        assert restored._engine.device == torch.device("cpu")

    def test_dim_mismatch(self) -> None:
        users, items, umap, imap = _vectors()
        with pytest.raises(ValueError):
            UserToItemAnnRecommender(users[:, :4], items, IdMap.from_values(umap), IdMap.from_values(imap),
                                     device="cpu")
        from rectools_tpu.dataset import IdMap as JaxIdMap
        from rectools_tpu.tools import UserToItemAnnRecommender as JaxU2I

        with pytest.raises(ValueError):
            JaxU2I(users[:, :4], items, JaxIdMap.from_values(umap), JaxIdMap.from_values(imap))


class TestItemToItemAnnRecommender:
    def test_excludes_self(self) -> None:
        _, items, _, imap = _vectors()
        port, ref = _pair(I2I, items, maps=[imap])
        got = port.get_item_list_for_item("i0", top_n=5)
        assert "i0" not in got and len(got) == 5
        _same_lists([got], [ref.get_item_list_for_item("i0", top_n=5)])

    def test_batch(self) -> None:
        _, items, _, imap = _vectors()
        port, ref = _pair(I2I, items, maps=[imap])
        got = port.get_item_list_for_item_batch(["i0", "i1"], top_n=3)
        assert len(got) == 2 and all(len(g) == 3 for g in got)
        _same_lists(got, ref.get_item_list_for_item_batch(["i0", "i1"], top_n=3))

    @pytest.mark.parametrize("distance", DISTANCES)
    def test_duplicated_vectors_keep_jax_tie_order(self, distance: str) -> None:
        """Exact ties from copied vectors: self is dropped by id, its copies
        stay, lowest id first; index_top_k = 50 puts k past m = 12."""
        rng = np.random.default_rng(21)
        items = _objects(rng, 400, 16, distance)
        items[200:260] = items[7]  # 61 copies of one vector
        imap = list(range(400))
        port, ref = _pair(I2I, items, maps=[imap], index_top_k=50, distance=Distance[distance])
        targets = [7, 200, 259, 3, 399]
        got = port.get_item_list_for_item_batch(targets, top_n=10)
        _same_lists(got, ref.get_item_list_for_item_batch(targets, top_n=10))
        if distance != "EUCLIDEAN":  # a copy is as close as can be (DOT: unless a longer vector points the same way)
            assert 7 not in list(got[0])
        assert 200 not in list(got[1])


class TestApproximateMode:
    def test_high_recall_vs_exact(self) -> None:
        rng = np.random.default_rng(0)
        items = rng.normal(size=(2000, 32)).astype(np.float32)
        users = rng.normal(size=(20, 32)).astype(np.float32)
        maps = [np.arange(20), np.arange(2000)]
        exact, _ = _pair(U2I, users, items, maps=maps)
        approx, ref = _pair(U2I, users, items, maps=maps, approximate=True)
        overlaps = []
        for u in range(20):
            ap = approx.get_item_list_for_user(u, top_n=20)
            overlaps.append(len(set(exact.get_item_list_for_user(u, top_n=20)) & set(ap)) / 20)
            _same_lists([ap], [ref.get_item_list_for_user(u, top_n=20)])
        assert np.mean(overlaps) == 1.0  # served exactly

    def test_pickle_keeps_flag(self) -> None:
        rng = np.random.default_rng(0)
        items = rng.normal(size=(300, 8)).astype(np.float32)
        port, ref = _pair(I2I, items, maps=[np.arange(300)], approximate=True)
        restored = pickle.loads(pickle.dumps(port))
        assert restored.approximate is True
        got = restored.get_item_list_for_item(0, top_n=5)
        _same_lists([got], [port.get_item_list_for_item(0, top_n=5)])
        _same_lists([got], [ref.get_item_list_for_item(0, top_n=5)])


class TestDistancesAndTuning:
    def test_dot_distance_matches_brute_force(self) -> None:
        users, items, umap, imap = _vectors()
        port, ref = _pair(U2I, users, items, maps=[umap, imap], distance=Distance.DOT)
        got = port.get_item_list_for_user("u2", top_n=5)
        np.testing.assert_array_equal(got, np.asarray(imap)[np.argsort(-(items @ users[2]))[:5]])
        _same_lists([got], [ref.get_item_list_for_user("u2", top_n=5)])

    def test_recall_target_roundtrips_through_pickle(self) -> None:
        users, items, umap, imap = _vectors()
        port, ref = _pair(U2I, users, items, maps=[umap, imap], approximate=True, recall_target=0.85)
        restored = pickle.loads(pickle.dumps(port))
        assert restored.approximate and restored.recall_target == 0.85
        got = restored.get_item_list_for_user("u0", top_n=3)
        assert restored._engine.recall_target == 0.85 and restored._engine.approximate
        _same_lists([got], [ref.get_item_list_for_user("u0", top_n=3)])

    def test_i2i_excludes_self_even_with_overfetch(self) -> None:
        _, items, _, imap = _vectors()
        port, ref = _pair(I2I, items, maps=[imap], index_top_k=10)
        for item in ("i0", "i5", "i19"):
            got = port.get_item_list_for_item(item, top_n=6)
            assert item not in got and len(got) == 6
            _same_lists([got], [ref.get_item_list_for_item(item, top_n=6)])

    def test_i2i_whitelist_with_self_in_whitelist(self) -> None:
        _, items, _, imap = _vectors()
        port, ref = _pair(I2I, items, maps=[imap], index_top_k=20)
        allowed = ["i0", "i1", "i2", "i3"]
        got = port.get_item_list_for_item_batch(["i0"], top_n=3, item_available_ids=[allowed])
        assert "i0" not in got[0] and set(got[0]) <= set(allowed) - {"i0"}
        _same_lists(got, ref.get_item_list_for_item_batch(["i0"], top_n=3, item_available_ids=[allowed]))

    def test_dict_id_maps_accepted(self) -> None:
        users, items, *_ = _vectors()
        maps = [{f"u{i}": i for i in range(10)}, {f"i{i}": i for i in range(20)}]
        port, ref = _pair(U2I, users, items, maps=maps)
        got = port.get_item_list_for_user("u1", top_n=4)
        assert len(got) == 4
        _same_lists([got], [ref.get_item_list_for_user("u1", top_n=4)])


def test_ann_recommenders_default_to_cuda(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    users, items, umap, imap = _vectors()
    with pytest.raises(RuntimeError, match="cuda"):
        UserToItemAnnRecommender(users, items, IdMap.from_values(umap), IdMap.from_values(imap))
    with pytest.raises(RuntimeError, match="cuda"):
        ItemToItemAnnRecommender(items, IdMap.from_values(imap))
