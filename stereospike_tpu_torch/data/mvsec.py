"""MVSEC dataset: loading, preprocessing, Tulyakov splits, batching
(counterpart of ``stereospike_tpu/data/mvsec.py``).

Per sequence (reference ``MVSEC_sequence.__init__``, mvsec_dataset.py:106-207):

1. read ``<seq>_data`` (L/R events) and ``<seq>_gt`` (left rectified depth
   and its timestamps), see *Files* below;
2. crop take-off and landing frames by the per-split frame ranges
   (``mvsec_splits.json``);
3. fill GT holes by grayscale area closing, threshold 24 (the native host
   library, ``native/``);
4. zero depth → invalid, a boolean mask; label → LIN/LOG/DISP;
5. time-crop events to (ts[0] − 50 ms, ts[−1]);
6. rectify through the 4 calibration maps and bin into
   ``[n_chunks, nfpdm, H, W, 2]`` count frames, on the host by the native
   binner (by default, or streamed in ``event_block_rows`` blocks) or on the
   device (``device_voxelize``);
7. optional nonzero-normalisation; else the counts are stored as uint8.

Splits (``load_MVSEC``, mvsec_dataset.py:14-73): split k trains on the other
two sequences and carves val (fixed indices) and test out of sequence k.

*Files.* Each of ``<scenario><seq>_data`` and ``<scenario><seq>_gt`` is
either ``<stem>.hdf5`` (real MVSEC; read through h5py, imported only by
:func:`_open_hdf5`) or a directory ``<stem>/`` of ``.npy`` files at the
HDF5 dataset paths (``davis/left/events.npy``, ...), opened with
``np.load(mmap_mode="r")``, which answers the same ``shape``, ``[i, 2]``
and ``[a:b]`` reads. ``data/fixtures.py`` writes the latter, so the
``--synthetic`` path needs no h5py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import warnings
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from stereospike_tpu_torch.data.voxelizer import FRAME_H, FRAME_W, voxelize_sequence
from stereospike_tpu_torch.native import area_closing, rectify_bin_events

_SPLITS_PATH = os.path.join(os.path.dirname(__file__), "mvsec_splits.json")


def load_split_tables() -> Dict:
    with open(_SPLITS_PATH) as f:
        return json.load(f)


def _np_lin_to_log(depth: np.ndarray, Dmax=10.0, alpha=6.0) -> np.ndarray:
    d = np.clip(depth, 1e-30, Dmax) / Dmax
    return np.clip(1.0 + np.log(d) / alpha, 0.0, 1.0)


def _np_depth_to_disparity(depth: np.ndarray) -> np.ndarray:
    return 7.0 * 19.941772 / (depth + 1e-15)


def _pack_frames(d: np.ndarray) -> np.ndarray:
    """Event-count frames as uint8: counts per (pixel, polarity, bin) are
    small, so bytes are exact and cut host memory and the upload 4× (the
    steps cast to the compute dtype on the device). A count above 255 is
    clipped with a warning."""
    d = np.asarray(d)
    hi = float(d.max()) if d.size else 0.0
    if hi > 255.0:
        warnings.warn(f"event-count frame saturates uint8 (max count {hi:.0f}"
                      "); clipping — pass pack_uint8=False for exact floats")
        d = np.minimum(d, 255.0)
    return d.astype(np.uint8)


class NpyTree:
    """A directory of ``.npy`` files read like an open HDF5 file:
    ``tree["davis"]["left"]["events"]`` is ``davis/left/events.npy``,
    memory-mapped read-only."""

    def __init__(self, path: str):
        self.path = path

    def __getitem__(self, key: str):
        sub = os.path.join(self.path, key)
        if os.path.isdir(sub):
            return NpyTree(sub)
        if os.path.exists(sub + ".npy"):
            return np.load(sub + ".npy", mmap_mode="r")
        raise KeyError(f"{key!r} not in {self.path}")


def _open_hdf5(path: str):
    """Open an HDF5 file for reading; the one place the port imports h5py."""
    import h5py

    return h5py.File(path, "r")


@contextlib.contextmanager
def open_sequence_file(stem: str):
    """``<stem>.hdf5`` through h5py when it exists, else the ``.npy`` tree
    ``<stem>/``; neither → FileNotFoundError naming both."""
    h5 = stem + ".hdf5"
    if os.path.exists(h5):
        f = _open_hdf5(h5)
        try:
            yield f
        finally:
            f.close()
    elif os.path.isdir(stem):
        yield NpyTree(stem)
    else:
        raise FileNotFoundError(f"neither {h5} nor the .npy directory {stem}/ exists")


@dataclasses.dataclass
class MvsecSequence:
    """One preprocessed sequence (channel-last):

    data_left/right: [n_chunks, nfpdm, H, W, 2] counts (uint8, or float32
    when normalized); labels [n_chunks, H, W, 1] float32 in the learned
    metric; masks [n_chunks, H, W, 1] bool."""

    data_left: np.ndarray
    data_right: np.ndarray
    labels: np.ndarray
    masks: np.ndarray
    n_warmup: int
    n_train: int

    def __len__(self) -> int:
        return self.labels.shape[0] - (self.n_warmup + self.n_train)

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        """One training sample (mvsec_dataset.py:212-242)."""
        nw, nt = self.n_warmup, self.n_train
        off = nw + nt  # the main arrays start at chunk nw + nt
        if index - nt - nw - 1 >= 0:
            base = off + index  # absolute chunk index of the sample's last chunk
            init = base - nt - nw
            warm = slice(base - nt - nw + 1, base - nt + 1)
            train = slice(base - nt + 1, base + 1)
            gt_idx = base
        else:
            init = index
            warm = slice(index + 1, index + 1 + nw)
            train = slice(index + 1 + nw, index + 1 + nw + nt)
            gt_idx = index + nw + nt
        return {
            "init_pots": self.labels[init],
            "init_mask": self.masks[init],
            "warmup_left": self.data_left[warm],
            "warmup_right": self.data_right[warm],
            "chunks_left": self.data_left[train],
            "chunks_right": self.data_right[train],
            "gt": self.labels[gt_idx],
            "mask": self.masks[gt_idx],
        }


def _first_row_with_t_above(dset, val: float, strict: bool = True) -> int:
    """Binary search of a time-sorted [N, 4] events dataset: the first row
    whose timestamp is > ``val`` (``strict``) or >= ``val``, by O(log N)
    single-row reads."""
    lo, hi = 0, dset.shape[0]
    while lo < hi:
        mid = (lo + hi) // 2
        t = float(dset[mid, 2])
        if t < val or (strict and t == val):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _normalize_nonzero(*frames: np.ndarray) -> None:
    """Nonzero-normalisation in place (mvsec_dataset.py:183-192)."""
    for d in frames:
        nz = d > 0
        m, s = d[nz].mean(), d[nz].std()
        d[nz] = (d[nz] - m) / s


def load_sequence(root: str, scenario: str, split: str, sequence: str, *, nfpdm: int = 1,
                  warmup_chunks: int = 1, train_chunks: int = 1, learn_on: str = "LIN",
                  normalize: bool = False, area_threshold: int = 24,
                  tables: Optional[Dict] = None, hw: Tuple[int, int] = (FRAME_H, FRAME_W),
                  device_voxelize: bool = False, event_block_rows: Optional[int] = None,
                  pack_uint8: bool = True,
                  device: Union[str, torch.device] = "cuda") -> MvsecSequence:
    """Load and preprocess one sequence from
    ``<root>/<scenario>/<scenario><seq>_{data,gt}`` (``.hdf5`` or ``.npy``
    tree) and ``<scenario>_calib/*_{x,y}_map.txt``. ``tables`` overrides the
    packaged split tables (the synthetic fixtures use it); ``device`` is
    where ``device_voxelize`` bins."""
    if normalize and pack_uint8:
        warnings.warn("normalize=True keeps count frames float32 — the pack_uint8 "
                      "4x host-RAM/H2D saving does not apply to normalized frames",
                      stacklevel=2)
    tables = load_split_tables() if tables is None else tables
    seq_name = f"{scenario}{sequence}"
    start, end = tables["frame_ranges"][scenario][f"split{split}"][seq_name]
    stem = os.path.join(root, scenario, seq_name)

    with open_sequence_file(stem + "_gt") as f:
        depth = np.array(f["davis"]["left"]["depth_image_rect"], np.float32)
        depth_ts = np.array(f["davis"]["left"]["depth_image_rect_ts"], np.float64)
    depth, depth_ts = depth[start:end], depth_ts[start:end]

    # hole filling and the validity mask (zeros and NaN are invalid)
    for i in range(depth.shape[0]):
        depth[i] = area_closing(np.nan_to_num(depth[i], nan=0.0), area_threshold)
    masks = depth > 0

    labels = depth.copy()
    if learn_on == "LOG":
        labels = _np_lin_to_log(labels)
    elif learn_on == "DISP":
        labels = _np_depth_to_disparity(labels)
    elif learn_on != "LIN":
        raise ValueError("learn_on must be LIN, LOG or DISP")
    labels = np.where(masks, labels, 0.0).astype(np.float32)

    calib = os.path.join(root, scenario, f"{scenario}_calib")
    maps = {side: (np.loadtxt(os.path.join(calib, f"{scenario}_{side}_x_map.txt")),
                   np.loadtxt(os.path.join(calib, f"{scenario}_{side}_y_map.txt")))
            for side in ("left", "right")}
    # time-crop to the retained GT window (mvsec_dataset.py:166-167)
    t_lo, t_hi = depth_ts[0] - 0.05, depth_ts[-1]
    n_chunks = depth_ts.shape[0]
    dt = 1.0 / (20.0 * nfpdm)
    shape = (n_chunks, nfpdm, hw[0], hw[1], 2)

    if event_block_rows:
        # memory-bounded build: binary-search the crop bounds on the
        # time-sorted events column, then stream fixed-size row blocks into
        # the native binner (a pure scatter-add, so per-block accumulation
        # into one buffer is exact)
        if device_voxelize:
            raise ValueError("event_block_rows streams through the host binner; "
                             "device_voxelize needs the full table (unset one)")
        out = {}
        with open_sequence_file(stem + "_data") as f:
            for side in ("left", "right"):
                dset = f["davis"][side]["events"]
                i0 = _first_row_with_t_above(dset, t_lo)
                i1 = _first_row_with_t_above(dset, t_hi, strict=False)
                frames = np.zeros((n_chunks * nfpdm, hw[0], hw[1], 2), np.float32)
                t0 = float(dset[i0, 2]) if i1 > i0 else 0.0
                for s in range(i0, i1, int(event_block_rows)):
                    blk = np.array(dset[s:min(s + int(event_block_rows), i1)], np.float64)
                    rectify_bin_events(blk, n_chunks * nfpdm, t0, dt, x_map=maps[side][0],
                                       y_map=maps[side][1], height=hw[0], width=hw[1],
                                       out=frames)
                out[side] = frames.reshape(shape)
        data_l, data_r = out["left"], out["right"]
    else:
        with open_sequence_file(stem + "_data") as f:
            # float64: real stamps are ROS epoch seconds (~1.5e9), which
            # float32 resolves to ~128 s; the binners remove the first-event
            # offset at full precision and only then narrow
            ev_l = np.array(f["davis"]["left"]["events"], np.float64)
            ev_r = np.array(f["davis"]["right"]["events"], np.float64)
        ev_l = ev_l[(ev_l[:, 2] > t_lo) & (ev_l[:, 2] < t_hi)]
        ev_r = ev_r[(ev_r[:, 2] > t_lo) & (ev_r[:, 2] < t_hi)]
        if device_voxelize:
            data_l, data_r = (voxelize_sequence(ev, n_chunks, nfpdm, x_map=maps[side][0],
                                                y_map=maps[side][1], height=hw[0],
                                                width=hw[1], device=device)
                              for ev, side in ((ev_l, "left"), (ev_r, "right")))
        else:
            data_l, data_r = (rectify_bin_events(ev, n_chunks * nfpdm, float(ev[0, 2]), dt,
                                                 x_map=maps[side][0], y_map=maps[side][1],
                                                 height=hw[0], width=hw[1]).reshape(shape)
                              for ev, side in ((ev_l, "left"), (ev_r, "right")))

    if normalize:
        _normalize_nonzero(data_l, data_r)
    elif pack_uint8:
        data_l, data_r = _pack_frames(data_l), _pack_frames(data_r)
    return MvsecSequence(data_left=data_l, data_right=data_r, labels=labels[..., None],
                         masks=masks[..., None], n_warmup=warmup_chunks,
                         n_train=train_chunks)


@dataclasses.dataclass
class MvsecView:
    """A (sub)set of samples over one or more sequences."""

    sequences: List[MvsecSequence]
    indices: List[Tuple[int, int]]  # (sequence_id, sample_index)

    def __len__(self) -> int:
        return len(self.indices)

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        seq_id, idx = self.indices[i]
        return self.sequences[seq_id].sample(idx)


def load_mvsec(root: str, scenario: str = "indoor_flying", split: str = "1", *,
               nfpdm: int = 1, warmup_chunks: int = 1, train_chunks: int = 1,
               learn_on: str = "LIN", normalize: bool = False, load_test_only: bool = False,
               tables: Optional[Dict] = None, hw: Tuple[int, int] = (FRAME_H, FRAME_W),
               event_block_rows: Optional[int] = None, pack_uint8: bool = True,
               device_voxelize: bool = False, device: Union[str, torch.device] = "cuda"):
    """(train, val, test) views by the Tulyakov split protocol (load_MVSEC,
    mvsec_dataset.py:14-73), or the test view alone with ``load_test_only``.
    ``event_block_rows`` bounds the build's event memory; ``pack_uint8``
    stores the counts as bytes; ``device_voxelize`` bins on ``device``."""
    tables = load_split_tables() if tables is None else tables
    info = tables["splits"][split]
    kw = dict(nfpdm=nfpdm, warmup_chunks=warmup_chunks, train_chunks=train_chunks,
              learn_on=learn_on, normalize=normalize, tables=tables, hw=hw,
              event_block_rows=event_block_rows, pack_uint8=pack_uint8,
              device_voxelize=device_voxelize, device=device)

    valtest = load_sequence(root, scenario, split, info["valtest_sequence"], **kw)

    def _in_range(idx):
        # the published index tables assume warmup = train = 1 chunk; longer
        # windows push the last few samples off the end of the sequence
        kept = [i for i in idx if i < len(valtest)]
        if len(kept) < len(idx):
            warnings.warn(f"dropped {len(idx) - len(kept)} val/test indices beyond the "
                          "sequence end (warmup/train windows longer than the split "
                          "tables assume)")
        return kept

    test = MvsecView([valtest], [(0, i) for i in _in_range(info["test_indices"])])
    if load_test_only:
        return test
    train_seqs = [load_sequence(root, scenario, split, s, **kw)
                  for s in info["train_sequences"]]
    train = MvsecView(train_seqs,
                      [(si, i) for si, s in enumerate(train_seqs) for i in range(len(s))])
    val = MvsecView([valtest], [(0, i) for i in _in_range(info["valid_indices"])])
    return train, val, test


def batches(view: MvsecView, batch_size: int, *, shuffle: bool = False,
            drop_last: bool = True, seed: int = 0, binocular: bool = True,
            include_warmup: bool = False, n_timesteps: int = 1,
            shard: Optional[Tuple[int, int]] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Host batches in the canonical layout.

    Each sample's [N_train, nfpdm, H, W, 2] chunks are spread over
    ``n_timesteps`` steps (which must divide N_train), each step carrying
    C = eyes · (N_train/n_timesteps) · nfpdm · 2 channels ordered (eye,
    chunk, frame, polarity): ``chunks`` [B, T, H, W, C] in the stored dtype,
    ``gt``/``init_pots`` [B, H, W, 1] float32, ``mask``/``init_mask`` bool,
    and ``warmup`` [B, Tw, H, W, C] with ``include_warmup``.

    The order is ``np.random.default_rng(seed)``'s shuffle when ``shuffle``.
    ``shard=(rank, world)``: every rank shuffles the same order, takes
    ``order[rank::world]`` and truncates to the shortest rank's length."""
    order = np.arange(len(view))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if shard is not None:
        rank, world = shard
        if not 0 <= rank < world:
            raise ValueError(f"shard rank {rank} outside world {world}")
        per_rank = len(order) // world  # the shortest length: equal step counts
        order = order[rank::world][:per_rank]

    n_train_chunks = view.sequences[0].n_train if len(view) else n_timesteps
    if n_train_chunks % n_timesteps:
        raise ValueError(f"n_timesteps={n_timesteps} must divide the "
                         f"{n_train_chunks} train chunks per sample")
    chunks_per_step = n_train_chunks // n_timesteps

    def stack_eye(chunks: np.ndarray) -> np.ndarray:
        # [N, nfpdm, H, W, 2] → [N/npt, H, W, npt·nfpdm·2], npt chunks per step
        n, f, h, w, p = chunks.shape
        if n % chunks_per_step:
            raise ValueError(f"{n} chunks do not divide into steps of {chunks_per_step}")
        t = n // chunks_per_step
        return (chunks.reshape(t, chunks_per_step, f, h, w, p)
                .transpose(0, 3, 4, 1, 2, 5)
                .reshape(t, h, w, chunks_per_step * f * p))

    def eyes(smp: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
        out = [stack_eye(smp[f"{prefix}_left"])]
        if binocular:
            out.append(stack_eye(smp[f"{prefix}_right"]))
        return np.concatenate(out, axis=-1)

    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        samples = [view.sample(int(i)) for i in order[s:s + batch_size]]
        batch = {
            "chunks": np.stack([eyes(smp, "chunks") for smp in samples]),
            "gt": np.stack([smp["gt"] for smp in samples]).astype(np.float32),
            "mask": np.stack([smp["mask"] for smp in samples]),
            "init_pots": np.stack([smp["init_pots"] for smp in samples]).astype(np.float32),
            # init_pots' mask travels with it: the time mirror swaps both pairs
            "init_mask": np.stack([smp["init_mask"] for smp in samples]),
        }
        if include_warmup:
            batch["warmup"] = np.stack([eyes(smp, "warmup") for smp in samples])
        yield batch
