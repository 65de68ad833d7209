"""DENSE synthetic (CARLA) monocular dataset (counterpart of
``stereospike_tpu/data/dense.py``).

Reference ``datasets/DENSE/dense_dataset.py``: per-depth-map .npy AER files
(TXYP quadruplets, signed polarity ±1) at 30 FPS, split into
``num_frames_per_depth_map`` time bins (``splitAERinto``, :7-31) and
accumulated into 2-channel count frames (``AERtoEVFrame``, :34-71); optional
whole-sequence time mirror (:158-166); monocular (``data_right = None``).

Here the per-event Python loops are replaced by the native host binner
(``native/``), and ``take_log`` applies the standard normalized log-depth transform so the
labels match the LOG learning metric.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Tuple

import numpy as np

from stereospike_tpu_torch.data.voxelizer import FRAME_H, FRAME_W
from stereospike_tpu_torch.native import rectify_bin_events


@dataclasses.dataclass
class DenseDataset:
    """data: [n_chunks, nfpdm, H, W, 2]; labels: [n_chunks, H, W, 1];
    masks: [n_chunks, H, W, 1] (all valid unless depth<=0/NaN)."""

    data: np.ndarray
    labels: np.ndarray
    masks: np.ndarray

    def __len__(self) -> int:
        return self.data.shape[0]

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        return {"chunks": self.data[i], "gt": self.labels[i],
                "mask": self.masks[i]}


def aer_to_xytp(aer: np.ndarray, aer_format: str = "TXYP") -> np.ndarray:
    """Reorder an AER quadruplet array to the voxelizer's XYTP convention.

    ``aer_format``: ``'TXYP'`` (the reference driver's default,
    ``dense_dataset.py:141``) or ``'XYTP'`` (the alternate layout
    ``AERtoEVFrame`` accepts, ``dense_dataset.py:60-71``).
    """
    if aer_format == "TXYP":
        return np.stack([aer[:, 1], aer[:, 2], aer[:, 0], aer[:, 3]], axis=1)
    if aer_format == "XYTP":
        return np.asarray(aer)
    raise ValueError(f"unknown AER format {aer_format!r}")


def load_dense(
    root: str,
    *,
    start_end: Tuple[int, int] = (0, None),
    nfpdm: int = 1,
    mirror_time: bool = False,
    take_log: bool = True,
    hw: Tuple[int, int] = (FRAME_H, FRAME_W),
    aer_format: str = "TXYP",
) -> DenseDataset:
    """Load a DENSE sequence directory (``events/data/*.npy`` +
    ``depth/data/*.npy``).

    ``aer_format``: column order of the .npy AER quadruplets (see
    :func:`aer_to_xytp`).
    """
    if aer_format not in ("TXYP", "XYTP"):
        raise ValueError(f"unknown AER format {aer_format!r}")
    h, w = hw
    ev_dir = os.path.join(root, "events", "data")
    d_dir = os.path.join(root, "depth", "data")
    ev_files = sorted(f for f in os.listdir(ev_dir) if f.endswith(".npy"))
    d_files = sorted(f for f in os.listdir(d_dir) if f.endswith(".npy"))

    chunks, labels = [], []
    for ev_f, d_f in zip(ev_files, d_files):
        ev = aer_to_xytp(np.load(os.path.join(ev_dir, ev_f)), aer_format)
        t0, t1 = float(ev[0, 2]), float(ev[-1, 2])
        dt = max((t1 - t0) / nfpdm, 1e-9)
        frames = rectify_bin_events(
            ev.astype(np.float32), nfpdm, t0, dt,
            height=h, width=w, polarity_mode="signed")
        chunks.append(frames)
        labels.append(np.load(os.path.join(d_dir, d_f)).astype(np.float32))

    data = np.stack(chunks)                      # [n, nfpdm, H, W, 2]
    y = np.stack(labels)[..., None]              # [n, H, W, 1]

    s, e = start_end
    data, y = data[s:e], y[s:e]

    if mirror_time:
        # reverse chunk order, frame order within chunks, and polarity
        # (dense_dataset.py:158-166 reverses chunks + polarities)
        mirr = data[::-1, ::-1, :, :, ::-1]
        data = np.concatenate([data, mirr], axis=0)
        y = np.concatenate([y, y[::-1]], axis=0)

    masks = np.isfinite(y) & (y > 0)
    if take_log:
        yl = np.clip(np.where(masks, y, 1e-30), 1e-30, 10.0) / 10.0
        y = np.clip(1.0 + np.log(yl) / 6.0, 0.0, 1.0).astype(np.float32)
    y = np.where(masks, y, 0.0).astype(np.float32)

    return DenseDataset(data=np.ascontiguousarray(data), labels=y, masks=masks)


def split_dense(ds: DenseDataset, val_frac: float = 0.15,
                test_frac: float = 0.15):
    """Contiguous (train, val, test) split of one DENSE sequence.

    The reference ships no DENSE training protocol (``dense_dataset.py`` is
    loader-only), so the framework defines one: val and test are the LAST
    contiguous fractions of the sequence — temporal data must not be split
    i.i.d. (neighbouring 33 ms windows are nearly identical; a shuffled
    split would leak train frames into eval).
    """
    n = len(ds)
    n_test = max(int(round(n * test_frac)), 1)
    n_val = max(int(round(n * val_frac)), 1)
    n_train = n - n_val - n_test
    if n_train <= 0:
        raise ValueError(f"sequence of {n} maps is too short for "
                         f"val_frac={val_frac}, test_frac={test_frac}")

    def view(sl: slice) -> DenseDataset:
        return DenseDataset(data=ds.data[sl], labels=ds.labels[sl],
                            masks=ds.masks[sl])

    return (view(slice(0, n_train)),
            view(slice(n_train, n_train + n_val)),
            view(slice(n_train + n_val, n)))


def dense_batches(ds: DenseDataset, batch_size: int, *, shuffle: bool = False,
                  seed: int = 0, drop_last: bool = True) -> Iterator[Dict]:
    """Batches in the canonical layout (monocular: C = nfpdm·2)."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        idx = order[s:s + batch_size]
        frames = []
        for i in idx:
            c = ds.data[int(i)]  # [nfpdm, H, W, 2]
            f, h, w, p = c.shape
            frames.append(c.transpose(1, 2, 0, 3).reshape(h, w, f * p)[None])
        yield {
            "chunks": np.stack(frames).astype(np.float32),
            "gt": ds.labels[idx],
            "mask": ds.masks[idx],
        }
