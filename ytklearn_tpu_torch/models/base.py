"""What the convex families share (``ytklearn_tpu/models/base.py``).

Each model has a flat f32 weight vector with its layout, init and masks, a
weighted-sum loss over its batch tensors, predictions, per-block
regularization vectors, and the reference's model text. The optimizer
(optimize/lbfgs.py) and the trainer (train.py) work on any of them.

`carry_weights` puts the JAX package's flat weight vector on a model's
device after checking it against the model's layout; the model text is
the other carrier between the two packages (byte-identical dumps of the
same weights).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config.params import CommonParams
from ..device import resolve_device
from ..io.fs import is_tmp_path
from ..io.reader import SparseDataset
from ..losses import create_loss


def gather_rows(table, idx):
    """table[idx] for a 1-D or 2-D weight table, as an embedding lookup.
    Its backward sorts the indices and sums each index's rows in parallel
    partial segments, with no atomics: repeatable on the card, and a
    heavily repeated index (the bias, slot 0 of every row) does not fall
    to one thread as in the accumulating `index_put_` of `table[idx]`."""
    if table.dim() == 1:
        return F.embedding(idx, table[:, None]).squeeze(-1)
    return F.embedding(idx, table)


def random_init(params: CommonParams, size: int) -> np.ndarray:
    """Latent-factor init from numpy's RandomState(random.seed), as the
    reference draws it (utils/RandomParamsUtils.java:37): normal(mean,
    std) or uniform[a, b)."""
    r = params.random
    rng = np.random.RandomState(r.seed)
    if r.mode == "uniform":
        return rng.uniform(r.uniform_range_start, r.uniform_range_end,
                           size).astype(np.float32)
    return (rng.randn(size) * r.normal_std + r.normal_mean).astype(np.float32)


class ConvexModel:
    """Base of the L-BFGS-trained models, on one device."""

    name = "base"
    n_labels = 1  # K for the multiclass family

    def __init__(self, params: CommonParams, n_features: int, device=None):
        self.params = params
        self.n_features = n_features
        self.device = resolve_device(device)
        self.loss = create_loss(params.loss.loss_function)

    # -- layout ----------------------------------------------------------

    @property
    def dim(self) -> int:
        raise NotImplementedError

    def layout(self) -> List[Tuple[str, int, int, Tuple[int, ...]]]:
        """[(part, start, end, shape)]: the flat vector's segments and the
        shape each is viewed as."""
        raise NotImplementedError

    def init_weights(self) -> np.ndarray:
        return np.zeros((self.dim,), np.float32)

    def regular_blocks(self) -> List[Tuple[int, int]]:
        """[(start, end)] ranges regularized by l1[r] / l2[r]
        (reference: HoagOptimizer.getRegularStart/End overrides)."""
        raise NotImplementedError

    def reg_vectors(self, l1, l2) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-index l1 and l2 vectors on the device from the per-block
        lists (a scalar goes to every block)."""
        blocks = self.regular_blocks()
        l1s = np.broadcast_to(np.atleast_1d(l1), (len(blocks),))
        l2s = np.broadcast_to(np.atleast_1d(l2), (len(blocks),))
        l1v = np.zeros((self.dim,), np.float32)
        l2v = np.zeros((self.dim,), np.float32)
        for (s, e), a, b in zip(blocks, l1s, l2s):
            l1v[s:e] = a
            l2v[s:e] = b
        return (torch.from_numpy(l1v).to(self.device),
                torch.from_numpy(l2v).to(self.device))

    # -- batches ---------------------------------------------------------

    def make_batch(self, ds: SparseDataset) -> Tuple[np.ndarray, ...]:
        """Host arrays of the model's batch, every one row-aligned:
        (idx, val, y, weight) by default."""
        return (ds.idx, ds.val, ds.y, ds.weight)

    def device_batch(self, ds: SparseDataset) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in self.make_batch(ds))

    def score_bytes_per_row(self, width: int) -> int:
        """Bytes of a row's score intermediates on the card (the gathered
        weights); models with latent gathers override it."""
        return width * 4

    def suggest_row_chunk(self, n_rows: int, width: int,
                          n_shards: int = 1) -> Optional[int]:
        """Row chunk of the blocked loss/grad/score evaluation, or None
        when the whole batch fits the budget (YTK_ROW_CHUNK,
        YTK_CHUNK_BUDGET_MB; x4: the forward intermediate and its
        backward's). `n_rows` is the global row count over `n_shards`
        ranks: the chunk is a rank's, over its own rows."""
        from ..optimize.blocked import suggest_chunk

        return suggest_chunk(n_rows, 4 * self.score_bytes_per_row(width),
                             n_shards=n_shards)

    # -- math ------------------------------------------------------------

    def pure_loss(self, w, *batch):
        """Weighted-sum data loss; zero-weight rows are masked before the
        weighting (inf * 0 of e.g. mape on a zero label must not make the
        sum NaN)."""
        *xargs, y, weight = batch
        per_row = torch.where(weight > 0, self.loss.loss(self.scores(w, *xargs),
                                                          y), 0.0)
        return torch.sum(weight * per_row)

    def scores(self, w, *xargs):
        raise NotImplementedError

    def predicts(self, w, *batch):
        *xargs, _y, _w = batch
        return self.loss.predict(self.scores(w, *xargs))

    # -- model text ------------------------------------------------------

    def _part_paths(self, rank: int) -> Tuple[str, str]:
        p = self.params.model
        return (f"{p.data_path}/model-{rank:05d}",
                f"{p.data_path}_dict/dict-{rank:05d}")

    def _feature_slice(self, rank: int, n_parts: int) -> Tuple[int, int]:
        avg = self.n_features // n_parts
        start = rank * avg
        end = self.n_features if rank == n_parts - 1 else (rank + 1) * avg
        return start, end

    def dump_model(self, fs, w: np.ndarray, precision: Optional[np.ndarray],
                   feature_map: Dict[str, int], rank: int = 0,
                   n_parts: int = 1) -> None:
        """One text line a feature (`model_line`) into
        `<data_path>/model-%05d` and its names into
        `<data_path>_dict/dict-%05d`, both written atomically; the
        transform sidecar is stamped with the model text's digest first."""
        p = self.params.model
        start, end = self._feature_slice(rank, n_parts)
        model_path, dict_path = self._part_paths(rank)
        model_lines: List[str] = []
        dict_lines: List[str] = []
        for name, i in feature_map.items():
            if not (start <= i < end):
                continue
            is_bias = name.lower() == p.bias_feature_name.lower()
            line = self.model_line(name, i, w, precision, is_bias)
            if line is None:
                continue
            model_lines.append(line + "\n")
            if not is_bias:
                dict_lines.append(name + "\n")
        self._write(fs, model_path, dict_path, model_lines, dict_lines,
                    rank, n_parts)

    def _write(self, fs, model_path, dict_path, model_lines, dict_lines,
               rank, n_parts) -> None:
        self._stamp_transform_sidecar(fs, "".join(model_lines), rank, n_parts)
        with fs.atomic_open(model_path) as mf, fs.atomic_open(dict_path) as df:
            mf.writelines(model_lines)
            df.writelines(dict_lines)

    def _stamp_transform_sidecar(self, fs, model_text: str, rank: int,
                                 n_parts: int) -> None:
        """The digest of the model text about to land, into the transform
        sidecar (single-part dumps only; multi-part sidecars stay
        digestless)."""
        if rank != 0 or n_parts != 1:
            return
        if not self.params.feature.transform.switch_on:
            return
        from ..transform.sidecar import model_text_digest, stamp_sidecar_digest

        side = self.params.model.data_path + "_feature_transform_stat"
        stamp_sidecar_digest(fs, side, model_text_digest(model_text))

    def model_line(self, name: str, i: int, w: np.ndarray, precision,
                   is_bias: bool) -> Optional[str]:
        raise NotImplementedError

    def _read_lines(self, fs):
        """delim-split lines of every model part, in sorted path order."""
        p = self.params.model
        for path in sorted(fs.recur_get_paths([p.data_path])):
            if is_tmp_path(path):
                continue  # an atomic writer's temp file
            with fs.open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    info = line.split(p.delim)
                    if len(info) >= 2:
                        yield info

    def load_model(self, fs, feature_map: Dict[str, int]
                   ) -> Optional[np.ndarray]:
        """The dumped weights over `init_weights()`; unknown names skip;
        None when there is no model."""
        if not fs.exists(self.params.model.data_path):
            return None
        w = self.init_weights()
        for info in self._read_lines(fs):
            gidx = feature_map.get(info[0])
            if gidx is not None:
                self.apply_model_line(w, gidx, info)
        return w

    def apply_model_line(self, w: np.ndarray, gidx: int,
                         info: Sequence[str]) -> None:
        raise NotImplementedError


def carry_weights(jax_w: np.ndarray, model: ConvexModel) -> torch.Tensor:
    """The JAX package's flat f32 weight vector, checked against `model`'s
    layout, on the model's device (bit for bit)."""
    w = np.asarray(jax_w)
    if w.dtype != np.float32 or w.shape != (model.dim,):
        raise ValueError(f"{model.name}: weights {w.dtype}{w.shape}, the "
                         f"layout needs float32({model.dim},)")
    end = 0
    for part, s, e, shape in model.layout():
        if s != end or e - s != int(np.prod(shape)):
            raise ValueError(f"{model.name}: segment {part} [{s}, {e}) does "
                             f"not hold {shape}")
        w[s:e].reshape(shape)
        end = e
    if end != model.dim:
        raise ValueError(f"{model.name}: the layout covers {end} of "
                         f"{model.dim} weights")
    return torch.from_numpy(w.copy()).to(model.device)
