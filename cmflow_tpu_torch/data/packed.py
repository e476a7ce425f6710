"""Packed binary dataset: one memory-mapped file per split (a copy of
``cmflow_tpu/data/packed.py``).

The json reader pays a file open and a parse per sample per epoch.
``pack_split`` converts a split's json tree into one flat binary file and a
numpy index, and ``PackedVodDataset`` serves samples by slicing a memmap: no
parsing, no file opened per sample.

Format (little-endian), ``CMFPACK1``, the JAX package's byte for byte
(where the clouds have the format's 7 columns; see ``_cloud``):
    header: magic b'CMFPACK1', int64 n_samples
    index:  per sample, int64 offset (bytes, from file start) — stored in
            the sidecar '<name>.idx.npy' together with clip metadata
    blob:   per sample:
            int32 n1, n2, has_opt
            float32 pc1[n1,7], pc2[n2,7], trans[4,4],
                    gt_mask[n1], gt_labels[n1,3],
                    pse_mask[n1], pse_labels[n1,3],
                    (radar_u[n1], radar_v[n1], opt_flow[n1,2]  if has_opt)

The samples are read through the C++ codec (``data/vod.py``), so a packed
split serves the json reader's values bit for bit.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from cmflow_tpu_torch.data.schema import Sample
from cmflow_tpu_torch.data.vod import (
    VOD_CAMERA_PROJECTION,
    VOD_INTERVAL,
    VOD_RADAR_RES,
    VOD_T_CAMERA_RADAR,
    _list_clips,
    _list_samples,
    _sample_indices,
    load_sample_file,
)

MAGIC = b"CMFPACK1"


def _np(x, dtype=np.float32):
    return np.asarray(x, dtype)


def _cloud(x) -> np.ndarray:
    """A cloud as the format's 7 float32 columns.  The preprocessing writes
    5 (x, y, z, RCS, v_r; ``preprocess/flow_samples.py``), which are padded
    with zeros here: the JAX package's ``pack_split`` writes them unpadded,
    and its reader then reads them as 7 columns (ROADMAP Queue 3)."""
    pc = _np(x)
    if pc.ndim != 2 or not 5 <= pc.shape[1] <= 7:
        raise ValueError(f"a cloud of shape {pc.shape}; want [N, 5..7]")
    return np.pad(pc, ((0, 0), (0, 7 - pc.shape[1])))


def pack_split(json_root: str, partition: str, out_path: str,
               log=print) -> int:
    """Pack ``<json_root>/<partition>`` into ``out_path`` (+ .idx.npy).

    Both files are written under temporary names and moved into place, the
    index first: a reader that finds ``out_path`` finds it whole, and ranks
    that pack the same split at once each write the same bytes."""
    root = os.path.join(json_root, partition)
    offsets: List[int] = []
    clips_info = []
    n_written = 0
    tmp = f"{out_path}.{os.getpid()}.tmp"

    with open(tmp, "wb") as out:
        out.write(MAGIC)
        out.write(np.int64(0).tobytes())  # patched at the end

        for clip in _list_clips(root):
            if clip[:5] != "delft":  # the same filter as VodDataset
                continue
            paths = _list_samples(os.path.join(root, clip))
            clips_info.append(
                {"clip_name": clip,
                 "index": [n_written, n_written + len(paths)]})
            for p in paths:
                raw = load_sample_file(p)
                pc1 = _cloud(raw["pc1"])
                pc2 = _cloud(raw["pc2"])
                opt = raw.get("opt_info") or {}
                radar_u = _np(opt.get("radar_u", []))
                has_opt = radar_u.size > 0

                offsets.append(out.tell())
                out.write(np.array(
                    [pc1.shape[0], pc2.shape[0], int(has_opt)],
                    np.int32).tobytes())
                out.write(pc1.tobytes())
                out.write(pc2.tobytes())
                out.write(_np(raw["trans"]).tobytes())
                out.write(_np(raw["gt_mask"]).tobytes())
                out.write(_np(raw["gt_labels"]).tobytes())
                out.write(_np(raw["pse_mask"]).tobytes())
                out.write(_np(raw["pse_labels"]).tobytes())
                if has_opt:
                    out.write(radar_u.tobytes())
                    out.write(_np(opt["radar_v"]).tobytes())
                    out.write(_np(opt["opt_flow"]).tobytes())
                n_written += 1

        out.seek(len(MAGIC))
        out.write(np.int64(n_written).tobytes())

    with open(tmp + ".idx", "wb") as f:
        np.save(f, {"offsets": np.array(offsets, np.int64),
                    "clips_info": clips_info}, allow_pickle=True)
    os.replace(tmp + ".idx", out_path + ".idx.npy")
    os.replace(tmp, out_path)
    log(f"packed {partition}: {n_written} samples -> {out_path}")
    return n_written


class PackedVodDataset:
    """Drop-in replacement for ``VodDataset`` backed by a packed split
    file.  ``_rng`` draws the training subsamples in item order, and
    :meth:`get` draws them from a generator the caller gives (the loader's
    ``shard=``), as ``VodDataset`` does."""

    def __init__(self, pack_path: str, partition: str = "train",
                 num_points: int = 256, eval_mode: bool = False,
                 seed: int = 1234, log=print):
        self.num_points = num_points
        self.eval_mode = eval_mode
        self.partition = partition
        self.res = dict(VOD_RADAR_RES)
        self.camera_projection_matrix = VOD_CAMERA_PROJECTION
        self.t_camera_radar = VOD_T_CAMERA_RADAR
        self.interval = VOD_INTERVAL
        self._rng = np.random.default_rng(seed)

        self._mm = np.memmap(pack_path, np.uint8, "r")
        if bytes(self._mm[:8]) != MAGIC:
            raise ValueError(f"{pack_path}: not a {MAGIC.decode()} file")
        self._n = int(np.frombuffer(self._mm[8:16], np.int64)[0])
        meta = np.load(pack_path + ".idx.npy", allow_pickle=True).item()
        self._offsets = meta["offsets"]
        self.clips_info = meta["clips_info"] if eval_mode else []
        log(f"{partition} (packed) : {self._n}")

    def __len__(self) -> int:
        return self._n

    def _read(self, i: int):
        off = int(self._offsets[i])
        hdr = np.frombuffer(self._mm[off:off + 12], np.int32)
        n1, n2, has_opt = int(hdr[0]), int(hdr[1]), int(hdr[2])
        pos = off + 12

        def take(count, shape):
            nonlocal pos
            nbytes = count * 4
            arr = np.frombuffer(self._mm[pos:pos + nbytes],
                                np.float32).reshape(shape)
            pos += nbytes
            return arr

        pc1 = take(n1 * 7, (n1, 7))
        pc2 = take(n2 * 7, (n2, 7))
        trans = take(16, (4, 4))
        gt_mask = take(n1, (n1,))
        gt_labels = take(n1 * 3, (n1, 3))
        pse_mask = take(n1, (n1,))
        pse_labels = take(n1 * 3, (n1, 3))
        if has_opt:
            radar_u = take(n1, (n1,))
            radar_v = take(n1, (n1,))
            opt_flow = take(n1 * 2, (n1, 2))
        else:
            radar_u = np.zeros(n1, np.float32)
            radar_v = np.zeros(n1, np.float32)
            opt_flow = np.zeros((n1, 2), np.float32)
        return (pc1, pc2, trans, gt_mask, gt_labels, pse_mask, pse_labels,
                radar_u, radar_v, opt_flow)

    def __getitem__(self, index: int) -> Sample:
        return self.get(index, self._rng)

    def get(self, index: int, rng: np.random.Generator) -> Sample:
        """Sample ``index``, a training subsample drawn from ``rng``."""
        (pc1, pc2, trans, gt_mask, gt_labels, pse_mask, pse_labels,
         radar_u, radar_v, opt_flow) = self._read(index)

        if self.partition in ("test", "val", "train_anno"):
            labels, mask = gt_labels, gt_mask
            radar_u = np.zeros(pc1.shape[0], np.float32)
            radar_v = np.zeros(pc1.shape[0], np.float32)
            opt_flow = np.zeros((pc1.shape[0], 2), np.float32)
        else:
            labels, mask = pse_labels, pse_mask

        pos_1, pos_2 = pc1[:, 0:3], pc2[:, 0:3]
        feature_1, feature_2 = pc1[:, [4, 3, 3]], pc2[:, [4, 3, 3]]
        trans = np.linalg.inv(trans).astype(np.float32)

        if not self.eval_mode:
            idx1 = _sample_indices(len(pos_1), self.num_points, rng)
            idx2 = _sample_indices(len(pos_2), self.num_points, rng)
            pos_1, feature_1 = pos_1[idx1], feature_1[idx1]
            pos_2, feature_2 = pos_2[idx2], feature_2[idx2]
            radar_u, radar_v = radar_u[idx1], radar_v[idx1]
            opt_flow, labels, mask = opt_flow[idx1], labels[idx1], mask[idx1]

        n1, n2 = pos_1.shape[0], pos_2.shape[0]
        return {
            "pc1": np.ascontiguousarray(pos_1),
            "pc2": np.ascontiguousarray(pos_2),
            "ft1": np.ascontiguousarray(feature_1),
            "ft2": np.ascontiguousarray(feature_2),
            "trans": trans, "labels": np.ascontiguousarray(labels),
            "mask": np.ascontiguousarray(mask.astype(np.float32)),
            "interval": np.float32(VOD_INTERVAL),
            "radar_u": np.ascontiguousarray(radar_u),
            "radar_v": np.ascontiguousarray(radar_v),
            "opt_flow": np.ascontiguousarray(opt_flow),
            "valid1": np.ones(n1, bool), "valid2": np.ones(n2, bool),
        }


def packed_vod_dataset(root: str, partition: str = "train",
                       eval_mode: bool = False, num_points: int = 256,
                       seed: int = 1234, log=print) -> PackedVodDataset:
    """The registry's ``vodPackedDataset``: serve ``<root>/<partition>.pack``,
    packing it from the json tree on first use."""
    pack = os.path.join(root, partition + ".pack")
    if not os.path.exists(pack):
        log(f"packing {partition} split -> {pack}")
        pack_split(root, partition, pack, log=log)
    return PackedVodDataset(pack, partition, num_points=num_points,
                            eval_mode=eval_mode, seed=seed, log=log)
