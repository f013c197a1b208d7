"""The port's GBDT text I/O and heap layout against the JAX package's.

Both packages parse the same model text; the dump must come back byte for
byte, and the perfect-heap arrays the kernels read must be equal element
for element, -0.0 sign bits included.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from serve_models import build_gbdt
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.tree import Tree as JTree
from ytklearn_tpu.serve import kernels as jkernels
from ytklearn_tpu_torch.gbdt.tree import GBDTModel, Tree
from ytklearn_tpu_torch.serve import kernels

NAMES = [f"f{i}" for i in range(7)]


def _ragged_tree(rng, depth, p_leaf=0.3):
    """JAX-side tree of max depth exactly `depth` (its leftmost spine runs
    the whole way) with early leaves elsewhere, random stats, and split
    values that are not exactly representable in f32."""
    t = JTree()

    def grow(nid, d, spine=True):
        t.hess_sum[nid] = float(rng.rand() * 10)
        t.sample_cnt[nid] = int(rng.randint(1, 1000))
        if d >= depth or (not spine and rng.rand() < p_leaf):
            t.leaf_value[nid] = float(rng.randn() * 0.3)
            return
        t.feat[nid] = 0
        t.feat_name[nid] = NAMES[rng.randint(len(NAMES))]
        t.split[nid] = float(rng.randn())
        t.gain[nid] = float(rng.rand())
        t.default_left[nid] = bool(rng.rand() < 0.5)
        left, right = t.add_children(nid)
        grow(left, d + 1, spine)
        grow(right, d + 1, False)

    grow(0, 0)
    return t


def _model_text(seed, n_trees, depth, base=0.25, with_stats=True):
    rng = np.random.RandomState(seed)
    model = JModel(
        base_prediction=base, num_tree_in_group=1, obj_name="sigmoid",
        trees=[_ragged_tree(rng, depth) for _ in range(n_trees)],
    )
    return model.dumps(with_stats=with_stats)


@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("seed,n_trees,depth", [(0, 5, 3), (1, 13, 6)])
def test_model_text_round_trip_byte_identical(seed, n_trees, depth, with_stats):
    text = _model_text(seed, n_trees, depth, with_stats=with_stats)
    want = JModel.loads(text).dumps(with_stats=with_stats)
    got = GBDTModel.loads(text).dumps(with_stats=with_stats)
    assert got == want
    # the stats-free dump of a stats-carrying text too
    assert GBDTModel.loads(text).dumps(with_stats=False) == \
        JModel.loads(text).dumps(with_stats=False)


def test_model_text_round_trip_serve_fixture(tmp_path):
    _pred, _names = build_gbdt(tmp_path, n_trees=9, depth=4)
    text = (tmp_path / "gbdt.model").read_text()
    assert GBDTModel.loads(text).dumps() == JModel.loads(text).dumps()


def test_parse_matches_field_for_field():
    text = _model_text(2, 6, 5)
    for a, b in zip(GBDTModel.loads(text).trees, JModel.loads(text).trees):
        for f in ("feat", "feat_name", "split", "left", "right",
                  "default_left", "leaf_value", "gain", "hess_sum",
                  "sample_cnt"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.max_depth() == b.max_depth()
        assert a.leaf_cnt() == b.leaf_cnt()


def test_bad_text_refused_like_jax():
    text = _model_text(3, 2, 2).replace("tree_num=2", "tree_num=3")
    for loads in (GBDTModel.loads, JModel.loads):
        with pytest.raises(ValueError, match="expected 3 trees"):
            loads(text)
    bad = "base_prediction=0.5\nclass_num=1\nobj=l2\ntree_num=1\n" \
          "booster[1] depth=1,node_num=1,leaf_cnt=1\n0:nonsense\n"
    for loads in (GBDTModel.loads, JModel.loads):
        with pytest.raises(ValueError, match="bad tree node line"):
            loads(bad)


def _vocab(trees):
    names = sorted({t.feat_name[i] for t in trees
                    for i in range(t.n_nodes()) if not t.is_leaf(i)})
    return {n: i for i, n in enumerate(names)}


def _assert_same_arrays(a, b):
    """a, b: heap_arrays dicts or HeapEnsembles."""
    if not isinstance(a, dict):
        a, b = vars(a), vars(b)
    for f in ("feat", "split", "dleft", "inner", "leaf"):
        x, y = a[f], b[f]
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f
        if x.dtype == np.float64:
            assert np.array_equal(np.signbit(x), np.signbit(y)), f


@pytest.mark.parametrize("depth", [1, 3, 10])
def test_heap_arrays_equal_jax(depth):
    text = _model_text(10 + depth, 3, depth)
    for a, b in zip(GBDTModel.loads(text).trees, JModel.loads(text).trees):
        assert a.max_depth() == depth
        ids = list(range(a.n_nodes()))
        _assert_same_arrays(a.heap_arrays(depth, feat_ids=ids),
                            b.heap_arrays(depth, feat_ids=ids))
        # a deeper heap than the tree needs: longer always-left pad chains
        if depth < kernels.HEAP_DEPTH_CAP:
            _assert_same_arrays(a.heap_arrays(depth + 1, feat_ids=ids),
                                b.heap_arrays(depth + 1, feat_ids=ids))


@pytest.mark.parametrize("depth,n_trees", [(1, 5), (3, 13), (10, 3)])
def test_build_heap_equal_jax(depth, n_trees):
    """T not a multiple of 8: the -0.0 pad trees must match too."""
    text = _model_text(20 + depth, n_trees, depth)
    mine, jax_trees = GBDTModel.loads(text).trees, JModel.loads(text).trees
    vocab = _vocab(jax_trees)
    a, why_a = kernels.build_heap(mine, vocab)
    b, why_b = jkernels.build_heap(jax_trees, vocab)
    assert why_a == why_b == ""
    assert (a.depth, a.n_trees, a.heap, a.last) == \
        (b.depth, b.n_trees, b.heap, b.last)
    assert a.depth == depth
    assert a.feat.shape[0] % 8 == 0 and a.feat.shape[0] > n_trees
    _assert_same_arrays(a, b)
    assert np.all(np.signbit(a.leaf[n_trees:]))  # -0.0 pad trees


def _chain(depth):
    """A left spine `depth` splits deep (one JAX tree, one port tree)."""
    out = []
    for cls in (JTree, Tree):
        t = cls()
        nid = 0
        for i in range(depth):
            t.feat[nid] = 0
            t.feat_name[nid] = "a"
            t.split[nid] = float(i)
            nid, _ = t.add_children(nid)
        out.append(t)
    return out


@pytest.mark.parametrize("case", ["empty", "leaf_only", "too_deep",
                                  "too_many_features"])
def test_build_heap_refusals_match_jax(case):
    if case == "empty":
        jt, pt, vocab = [], [], {"a": 0}
    elif case == "leaf_only":
        jt, pt, vocab = [JTree()], [Tree()], {}
    elif case == "too_deep":
        j, p = _chain(kernels.HEAP_DEPTH_CAP + 1)
        jt, pt, vocab = [j], [p], {"a": 0}
    else:
        j, p = _chain(2)
        jt, pt = [j], [p]
        vocab = {f"x{i}": i for i in range(4096)}
    a, why_a = kernels.build_heap(pt, vocab)
    b, why_b = jkernels.build_heap(jt, vocab)
    assert a is None and b is None
    assert why_a == why_b and why_a


def test_heap_depth_below_tree_depth_raises_like_jax():
    j, p = _chain(3)
    for t in (j, p):
        with pytest.raises(ValueError, match="heap depth 2 < tree depth 3"):
            t.heap_arrays(2, feat_ids=[0] * t.n_nodes())
