"""The port's data pipeline (``stereospike_tpu_torch/data/``) against the
JAX package's, on the CPU. Every comparison is exact.

- The MVSEC fixture: the port's ``.npy`` tree against the arrays the JAX
  fixture writes into its ``.hdf5`` files (read here with h5py), the
  calibration maps and the split tables, learnable and not.
- ``load_mvsec`` from the port's ``.npy`` tree and, through the port's
  h5py reader, from the JAX ``.hdf5`` tree, against the JAX ``load_mvsec``:
  LIN, LOG and DISP labels, ``normalize``, ``event_block_rows``,
  ``device_voxelize`` (binned by the port on the CPU, by the JAX package
  through its own scatter) and ``load_test_only``.
- ``batches`` with ``n_timesteps=5``, ``include_warmup``, a shuffle and
  ``shard``.
- DENSE: load (LIN and LOG), split and batches.
- Packing: the round trip, and the port's device unpack against JAX's on
  the same bytes.
- Neither the fixture nor the loader imports h5py on the ``.npy`` path.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from stereospike_tpu.data import dense as jax_dense
from stereospike_tpu.data import fixtures as jax_fixtures
from stereospike_tpu.data import mvsec as jax_mvsec
from stereospike_tpu.data.packing import pack_batch_host as jax_pack
from stereospike_tpu.data.packing import unpack_batch_device as jax_unpack
from stereospike_tpu_torch.data import dense, fixtures, mvsec
from stereospike_tpu_torch.data.packing import (
    pack_batch_host,
    packed_nbytes,
    unpack_batch_device,
)

ROOT = Path(__file__).resolve().parents[1]
HW = (32, 44)
FIXTURE = dict(hw=HW, n_depth=12, n_events=4000, seed=5)
ARRAYS = ("data_left", "data_right", "labels", "masks")


@pytest.fixture(scope="module", params=[False, True], ids=["noise", "learnable"])
def trees(request, tmp_path_factory):
    """(JAX .hdf5 root, port .npy root, tables) of one fixture."""
    learnable = request.param
    jroot = str(tmp_path_factory.mktemp("jax_fixture"))
    proot = str(tmp_path_factory.mktemp("port_fixture"))
    tables = jax_fixtures.make_mvsec_fixture(jroot, learnable=learnable, **FIXTURE)
    assert fixtures.make_mvsec_fixture(proot, learnable=learnable, **FIXTURE) == tables
    return jroot, proot, tables


def test_fixture_arrays_equal_the_jax_hdf5(trees):
    jroot, proot, tables = trees
    scen = "indoor_flying"
    with open(Path(proot) / "mini_splits.json") as f:
        assert json.load(f) == tables
    for name in ("left_x", "left_y", "right_x", "right_y"):
        side, axis = name.split("_")
        fname = f"{scen}_calib/{scen}_{side}_{axis}_map.txt"
        assert (Path(jroot, scen, fname).read_bytes()
                == Path(proot, scen, fname).read_bytes()), fname
    n = 0
    for seq in "123":
        for kind, keys in (("gt", ("depth_image_rect", "depth_image_rect_ts")),
                           ("data", ("events",))):
            with h5py.File(Path(jroot, scen, f"{scen}{seq}_{kind}.hdf5"), "r") as f:
                for side in (("left",) if kind == "gt" else ("left", "right")):
                    for key in keys:
                        theirs = f["davis"][side][key][()]
                        ours = np.load(Path(proot, scen, f"{scen}{seq}_{kind}", "davis", side,
                                            f"{key}.npy"))
                        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
                        np.testing.assert_array_equal(ours, theirs)
                        n += 1
    assert n == 3 * 4


def _assert_views_equal(ours, theirs):
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for vo, vt in zip(ours, theirs):
        assert vo.indices == vt.indices
        for so, st in zip(vo.sequences, vt.sequences):
            assert (so.n_warmup, so.n_train) == (st.n_warmup, st.n_train)
            for k in ARRAYS:
                a, b = getattr(so, k), getattr(st, k)
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)


LOADS = {
    "LIN": {}, "LOG": dict(learn_on="LOG"), "DISP": dict(learn_on="DISP"),
    "normalize": dict(normalize=True), "blocks": dict(event_block_rows=700),
    "test_only": dict(load_test_only=True),
    "nfpdm2_windows": dict(nfpdm=2, warmup_chunks=2, train_chunks=3),
}


@pytest.mark.parametrize("case", list(LOADS))
def test_load_mvsec_matches_jax(trees, case):
    jroot, proot, tables = trees
    kw = dict(hw=HW, tables=tables, **LOADS[case])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # normalize's uint8 note, dropped indices
        theirs = jax_mvsec.load_mvsec(jroot, **kw)
        from_npy = mvsec.load_mvsec(proot, **kw)
        from_hdf5 = mvsec.load_mvsec(jroot, **kw)
    _assert_views_equal(from_npy, theirs)
    _assert_views_equal(from_hdf5, theirs)


def test_device_voxelize_matches_jax(trees):
    """The ``device_voxelize`` build (the port bins in torch, here on the
    CPU; the JAX package through its jitted scatter) equals the host
    binner's and JAX's, sequence by sequence; so does the port's
    ``load_mvsec(device_voxelize=True)``."""
    jroot, proot, tables = trees
    kw = dict(hw=HW, tables=tables, device_voxelize=True)
    views = mvsec.load_mvsec(proot, device="cpu", **kw)
    host = mvsec.load_mvsec(proot, hw=HW, tables=tables)
    _assert_views_equal(views, host)
    for seq in "123":
        theirs = jax_mvsec.load_sequence(jroot, "indoor_flying", "1", seq, **kw)
        ours = mvsec.load_sequence(proot, "indoor_flying", "1", seq, device="cpu", **kw)
        for k in ARRAYS:
            np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k), err_msg=k)


@pytest.mark.parametrize("shard", [None, (1, 3)])
def test_batches_match_jax(trees, shard):
    jroot, proot, tables = trees
    kw = dict(hw=HW, tables=tables, warmup_chunks=2, train_chunks=5)
    theirs = jax_mvsec.load_mvsec(jroot, **kw)[0]
    ours = mvsec.load_mvsec(proot, **kw)[0]
    bkw = dict(shuffle=True, seed=7, n_timesteps=5, include_warmup=True, shard=shard,
               drop_last=False)
    got = list(mvsec.batches(ours, 3, **bkw))
    want = list(jax_mvsec.batches(theirs, 3, **bkw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["chunks"].shape[1] == 5 and g["warmup"].shape[1] == 2
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_missing_sequence_files_name_both_layouts(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"\.hdf5.*\.npy directory"):
        with mvsec.open_sequence_file(str(tmp_path / "indoor_flying1_gt")):
            pass


@pytest.mark.parametrize("take_log", [True, False], ids=["LOG", "LIN"])
def test_dense_matches_jax(tmp_path, take_log):
    jax_fixtures.make_dense_fixture(str(tmp_path / "j"), hw=HW, n_maps=9, seed=2)
    fixtures.make_dense_fixture(str(tmp_path / "p"), hw=HW, n_maps=9, seed=2)
    for sub in ("events", "depth"):
        for f in sorted((tmp_path / "j" / sub / "data").iterdir()):
            np.testing.assert_array_equal(np.load(tmp_path / "p" / sub / "data" / f.name),
                                          np.load(f))
    kw = dict(nfpdm=2, take_log=take_log, hw=HW)
    theirs = jax_dense.load_dense(str(tmp_path / "j"), **kw)
    ours = dense.load_dense(str(tmp_path / "p"), **kw)
    for k in ("data", "labels", "masks"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k), err_msg=k)
    for vo, vt in zip(dense.split_dense(ours), jax_dense.split_dense(theirs)):
        got = list(dense.dense_batches(vo, 2, shuffle=True, seed=3, drop_last=False))
        want = list(jax_dense.dense_batches(vt, 2, shuffle=True, seed=3, drop_last=False))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _host_batch(seed):
    rng = np.random.default_rng(seed)
    shape = (3, *HW, 1)
    return {"chunks": rng.integers(0, 4, (3, 1, *HW, 4)).astype(np.uint8),
            "gt": rng.uniform(0.5, 9.0, shape).astype(np.float32),
            "mask": rng.random(shape) < 0.7,
            "init_pots": rng.uniform(0.5, 9.0, shape).astype(np.float32),
            "init_mask": rng.random(shape) < 0.6}


def test_packing_round_trip_and_unpack_match_jax():
    batch = _host_batch(0)
    packed = pack_batch_host(batch)
    jpacked = jax_pack(batch)
    assert packed.keys() == jpacked.keys()
    for k in packed:
        np.testing.assert_array_equal(packed[k], jpacked[k], err_msg=k)
    assert packed_nbytes(packed) < packed_nbytes(batch)
    ours = unpack_batch_device({k: torch.from_numpy(v) for k, v in packed.items()})
    theirs = jax_unpack(packed)
    assert set(ours) == set(batch) == set(theirs)
    for k in batch:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
        assert ours[k].dtype == (torch.bool if k.endswith("mask") else
                                 torch.float32 if k != "chunks" else torch.uint8)
    for k in ("mask", "init_mask", "chunks"):
        np.testing.assert_array_equal(ours[k].numpy(), batch[k])  # lossless
    np.testing.assert_array_equal(ours["gt"].numpy(), batch["gt"].astype(np.float16))
    # an unpacked batch passes through
    plain = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert all(unpack_batch_device(plain)[k] is plain[k] for k in plain)


def test_npy_path_never_imports_h5py(tmp_path):
    code = ("import sys\n"
            "from stereospike_tpu_torch.data.fixtures import make_mvsec_fixture\n"
            "from stereospike_tpu_torch.data.mvsec import load_mvsec\n"
            f"t = make_mvsec_fixture({str(tmp_path)!r}, hw=(16, 20), n_depth=6, n_events=500)\n"
            f"load_mvsec({str(tmp_path)!r}, tables=t, hw=(16, 20))\n"
            "print('h5py' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip().splitlines()[-1] == "False"
