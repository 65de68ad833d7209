"""Host→device batch compression (counterpart of ``stereospike_tpu/data/packing.py``).

Event-count ``chunks`` already travel as uint8 (``data/mvsec.py``); this
compresses the other dense entries of a training upload:

- ``mask`` / ``init_mask`` [B, H, W, 1] bool → bit-packed uint8
  [B, ceil(H·W/8)] (``np.packbits``, MSB first; 8× fewer bytes, lossless);
- ``gt`` / ``init_pots`` float32 → float16 (2× fewer bytes; the label is
  quantized to ≤ 2⁻¹¹ relative, ~5 mm at 10 m).

:func:`unpack_batch_device` restores the canonical batch on the device
(bool masks, float32 labels) right after the upload, so every consumer
downstream sees the batch it always did. Gated by ``TrainConfig.pack_io``,
for training uploads only: eval batches stay float-exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_MASK_KEYS = ("mask", "init_mask")
_LABEL_KEYS = ("gt", "init_pots")
_BITS_SUFFIX = "__bits"


def pack_batch_host(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Bit-pack the masks (``<key>__bits`` [B, ceil(H·W/8)] replaces
    ``<key>``) and make the labels float16; other entries pass through."""
    out = dict(batch)
    for k in _MASK_KEYS:
        if k in out:
            m = np.asarray(out.pop(k))
            out[k + _BITS_SUFFIX] = np.packbits(m.astype(bool).reshape(m.shape[0], -1), axis=1)
    for k in _LABEL_KEYS:
        if k in out:
            out[k] = np.asarray(out[k]).astype(np.float16)
    return out


def _unpack_mask(bits: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """[B, nbytes] uint8 → bool ``shape`` (np.packbits' MSB-first order),
    by shifts on the uint8 bytes."""
    n = 1
    for d in shape[1:]:
        n *= d
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    u = (bits.unsqueeze(-1) >> shifts) & 1                  # [B, nbytes, 8]
    return u.reshape(bits.shape[0], -1)[:, :n].reshape(shape).bool()


def unpack_batch_device(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`pack_batch_host` on the tensors' device: bool
    masks at the label's [B, H, W, 1] shape, float32 labels. A batch that
    is not packed passes through unchanged."""
    out = dict(batch)
    ref = out.get("gt", out.get("init_pots"))
    for k in _MASK_KEYS:
        bk = k + _BITS_SUFFIX
        if bk in out:
            if ref is None:
                raise ValueError(f"packed batch has {bk} but no gt/init_pots entry to "
                                 "recover the mask's spatial shape from")
            out[k] = _unpack_mask(out.pop(bk), tuple(ref.shape))
    for k in _LABEL_KEYS:
        if k in out and out[k].dtype == torch.float16:
            out[k] = out[k].to(torch.float32)
    return out


def packed_nbytes(batch: Dict[str, np.ndarray]) -> int:
    """Total host bytes a batch dict puts on the wire."""
    return sum(np.asarray(v).nbytes for v in batch.values())
