"""The port's heap walk against the JAX package's fused Pallas kernel.

The JAX side runs its real kernel body under the Pallas interpreter
(`fused_scores(..., interpret=True)`, as tests/test_serve_kernels.py runs
it); the port's side is `heap_walk_plain`, and `heap_walk` on CPU tensors,
which must take the plain version. Both fold trees in ascending order in
f64, so the raw sums are compared with np.array_equal.
"""

import numpy as np
import pytest
import torch

from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.serve import kernels as jkernels
from ytklearn_tpu_torch.serve import kernels


def _random_heap(rng, T, depth, F, n_pad=0):
    """Perfect-heap arrays with random topology data; the last `n_pad`
    trees are the -0.0 pad trees build_heap appends, and a quarter of the
    slots are always-left pads (split=+inf, dleft=1, feat=0)."""
    H = (1 << (depth + 1)) - 1
    LL = 1 << depth
    feat = rng.randint(0, F, (T, H)).astype(np.int32)
    split = np.round(rng.randn(T, H), 1)  # coarse grid: rows hit splits
    dleft = rng.randint(0, 2, (T, H)).astype(np.int32)
    pad = rng.rand(T, H) < 0.25
    feat[pad], split[pad], dleft[pad] = 0, np.inf, 1
    leaf = rng.randn(T, LL)
    if n_pad:
        feat[-n_pad:], split[-n_pad:], dleft[-n_pad:] = 0, np.inf, 1
        leaf[-n_pad:] = -0.0
    return feat, split, dleft, leaf


def _rows(rng, B, F, split):
    """Rows mixing normal values, NaN, +-inf, and values exactly at split
    thresholds (and at -0.0 / +0.0)."""
    X = np.round(rng.randn(B, F), 1)
    r = rng.rand(B, F)
    X[r < 0.15] = np.nan
    X[(r >= 0.15) & (r < 0.2)] = np.inf
    X[(r >= 0.2) & (r < 0.25)] = -np.inf
    at = (r >= 0.25) & (r < 0.45)
    finite = split[np.isfinite(split)]
    X[at] = rng.choice(finite, size=int(at.sum()))
    X[(r >= 0.45) & (r < 0.5)] = -0.0
    return X


def _jax_fused(X, feat, split, dleft, leaf, depth):
    import jax.numpy as jnp

    return np.asarray(jkernels.fused_scores(
        jnp.asarray(X.T), jnp.asarray(feat), jnp.asarray(split),
        jnp.asarray(dleft), jnp.asarray(leaf), depth, interpret=True,
    ))


def _port(fn, X, ht):
    """The port's sums on CPU tensors: heap_walk on the node records,
    heap_walk_plain on the three arrays unpacked from them."""
    X = torch.from_numpy(X)
    if fn is kernels.heap_walk_plain:
        out = fn(X, *kernels.unpack_records(ht.nodes), ht.leaf, ht.depth)
    else:
        out = fn(X, ht.nodes, ht.leaf, ht.depth)
    assert out.dtype == torch.float64 and out.shape == (X.shape[0],)
    return out.numpy()


@pytest.mark.parametrize("T,depth,B,n_pad", [
    (8, 1, 5, 0), (16, 1, 33, 3), (8, 3, 17, 2), (8, 10, 9, 1),
    (24, 4, 70, 5),
    # depth 10 over several trees, and T past one of the kernel's chunks
    (24, 10, 13, 4), (kernels.WALK_CHUNK_CAP + 8, 2, 6, 8),
])
def test_plain_walk_bit_equal_to_pallas_interpret(T, depth, B, n_pad):
    rng = np.random.RandomState(T * 100 + depth)
    F = 6
    feat, split, dleft, leaf = _random_heap(rng, T, depth, F, n_pad)
    X = _rows(rng, B, F, split)
    want = _jax_fused(X, feat, split, dleft, leaf, depth)
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, depth, T - n_pad,
                                 "cpu")
    assert np.array_equal(_port(kernels.heap_walk_plain, X, ht), want)
    # the wrapper takes the plain version for CPU tensors, and launches
    # nothing (its count is of kernel launches only)
    before = kernels.heap_walk.launches
    assert np.array_equal(_port(kernels.heap_walk, X, ht), want)
    assert kernels.heap_walk.launches == before


def test_jax_heap_through_heap_from_numpy(tmp_path):
    """The JAX package's own HeapEnsemble arrays, carried across as numpy,
    walk to the JAX kernel's sums and to the host predictor's."""
    from serve_models import build_gbdt, request_rows

    pred, names = build_gbdt(tmp_path, n_trees=21, depth=5)
    trees = pred.model.trees
    vocab = {n: i for i, n in enumerate(sorted(
        {t.feat_name[i] for t in trees for i in range(t.n_nodes())
         if not t.is_leaf(i)}))}
    heap, why = jkernels.build_heap(trees, vocab)
    assert heap is not None, why
    rows = request_rows(40, np.random.RandomState(7), names)
    X = np.full((len(rows), len(vocab)), np.nan)
    for i, r in enumerate(rows):
        for k, v in r.items():
            if k in vocab:
                X[i, vocab[k]] = v
    ht = kernels.heap_from_numpy(heap.feat, heap.split, heap.dleft,
                                 heap.leaf, heap.depth, heap.n_trees, "cpu")
    got = _port(kernels.heap_walk, X, ht)
    want = _jax_fused(X, heap.feat, heap.split, heap.dleft, heap.leaf,
                      heap.depth)
    assert np.array_equal(got, want)
    # the host walk adds the base after the same fold
    assert np.array_equal(got + pred.model.base_prediction,
                          pred.batch_scores(rows))


def test_pad_trees_are_noops():
    """Appending -0.0 pad trees leaves every sum bit-identical, including
    sums that are exactly zero."""
    rng = np.random.RandomState(5)
    feat, split, dleft, leaf = _random_heap(rng, 8, 3, 4)
    leaf[:, :] = np.where(rng.rand(*leaf.shape) < 0.3, 0.0, leaf)
    X = _rows(rng, 31, 4, split)
    base = kernels.heap_from_numpy(feat, split, dleft, leaf, 3, 8, "cpu")
    pf, ps, pd, pl = _random_heap(rng, 8, 3, 4, n_pad=8)
    padded = kernels.heap_from_numpy(
        np.concatenate([feat, pf]), np.concatenate([split, ps]),
        np.concatenate([dleft, pd]), np.concatenate([leaf, pl]), 3, 8, "cpu")
    a = _port(kernels.heap_walk, X, base)
    b = _port(kernels.heap_walk, X, padded)
    assert np.array_equal(a, b)
    assert np.array_equal(np.signbit(a), np.signbit(b))


def test_rows_at_split_and_infinities_route_like_host_walk():
    """One depth-1 tree: v <= split goes left (value at the split included),
    +inf goes right, -inf left, NaN to dleft."""
    text = ("base_prediction=0.0\nclass_num=1\nobj=l2\ntree_num=1\n"
            "booster[1] depth=1,node_num=3,leaf_cnt=2\n"
            "0:[f_a<=0.5] yes=1,no=2,missing=2\n\t1:leaf=1.0\n\t2:leaf=2.0\n")
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    heap, _ = kernels.build_heap(GBDTModel.loads(text).trees, {"a": 0})
    jheap, _ = jkernels.build_heap(JModel.loads(text).trees, {"a": 0})
    assert np.array_equal(heap.leaf, jheap.leaf)
    ht = kernels.heap_from_numpy(heap.feat, heap.split, heap.dleft,
                                 heap.leaf, heap.depth, heap.n_trees, "cpu")
    X = np.array([[0.5], [0.5000001], [np.inf], [-np.inf], [np.nan],
                  [-0.0]])
    got = _port(kernels.heap_walk, X, ht)
    assert got.tolist() == [1.0, 2.0, 2.0, 1.0, 2.0, 1.0]
    assert np.array_equal(
        got, _jax_fused(X, heap.feat, heap.split, heap.dleft, heap.leaf, 1))


def test_empty_batch():
    rng = np.random.RandomState(1)
    feat, split, dleft, leaf = _random_heap(rng, 8, 2, 3)
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, 2, 8, "cpu")
    assert _port(kernels.heap_walk, np.zeros((0, 3)), ht).shape == (0,)


@pytest.mark.parametrize("bad", ["depth", "shape", "leaf", "n_trees", "feat"])
def test_heap_from_numpy_rejects_malformed(bad):
    rng = np.random.RandomState(2)
    feat, split, dleft, leaf = _random_heap(rng, 8, 3, 4)
    depth, n_trees = 3, 8
    if bad == "depth":
        depth = 11
    elif bad == "shape":
        split = split[:, :-1]
    elif bad == "leaf":
        leaf = leaf[:, :4]
    elif bad == "n_trees":
        n_trees = 9
    else:
        feat = feat.copy()
        feat[0, 0] = -1
    with pytest.raises(ValueError):
        kernels.heap_from_numpy(feat, split, dleft, leaf, depth, n_trees,
                                "cpu")


def test_heap_walk_refuses_feat_ids_past_the_row():
    """A heap built against a wider vocab than X's rows is refused before
    any walk: from the recorded max_feat, or from the ids themselves."""
    rng = np.random.RandomState(4)
    feat, split, dleft, leaf = _random_heap(rng, 8, 3, 6)
    feat[2, 0] = 5
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, 3, 8, "cpu")
    assert ht.max_feat == 5
    X = torch.from_numpy(_rows(rng, 4, 5, split))
    args = (X, ht.nodes, ht.leaf, ht.depth)
    with pytest.raises(ValueError, match="past X's 5 columns"):
        kernels.heap_walk(*args, max_feat=ht.max_feat)
    with pytest.raises(ValueError, match="past X's 5 columns"):
        kernels.heap_walk(*args)
    neg, nsplit, ndleft = kernels.unpack_records(ht.nodes)
    neg[0, 0] = -1
    with pytest.raises(ValueError, match="< 0"):
        kernels.heap_walk(X, kernels.node_records(neg, nsplit, ndleft),
                          *args[2:])


def test_kernel_build_needs_nvcc(monkeypatch):
    """On a machine without nvcc the build raises; it never hands over to
    the plain version."""
    from ytklearn_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_kernel()
