"""Port parity: the C++ sample codec and the packed dataset of
``cmflow_tpu_torch`` against the JAX package's, on the CPU.

Tolerance: none.  The port's codec is a copy of the JAX package's source,
built into the port's own ``build/native``: its parse equals JAX's
``native.parse_sample_file`` bit for bit.  ``pack_split`` writes a ``.pack``
byte-identical to JAX's and an index with equal offsets and clip info, and
the packed dataset's batches equal JAX's packed batches and the port's json
(codec) batches bit for bit, in every mode of the loader (shuffled train,
pinned and multiple eval buckets, a plan, ``shard=``).
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cmflow_tpu import native as jnative
from cmflow_tpu.data import BatchLoader as JaxBatchLoader
from cmflow_tpu.data import packed as jpacked
from cmflow_tpu.data import vod as jvod
from cmflow_tpu_torch.cli import main as climain
from cmflow_tpu_torch.data import BatchLoader, VodDataset, packed
from cmflow_tpu_torch.data import vod
from cmflow_tpu_torch.data.synthetic import write_synthetic_dataset
from cmflow_tpu_torch.native import codec

REPO = Path(__file__).resolve().parents[1]


def quiet(*args):
    pass


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("packsrc"))
    write_synthetic_dataset(root, {"train": 8, "val": 4, "test": 4},
                            clips_per_partition=2, seed=3, n_range=(90, 130))
    return root


def sample_files(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".json"))


def assert_same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same_tree(got[k], want[k], f"{where}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


# --------------------------------------------------------------------------
# the codec

def test_codec_builds_under_build():
    path = codec.build()
    assert path == codec.library_path()
    assert path.parent == REPO / "build" / "native" and path.is_file()
    assert path.name.startswith("libsamplecodec-")


def test_codec_parse_matches_jax(tree):
    files = sample_files(tree)
    assert len(files) == 16
    for path in files:
        assert_same_tree(codec.parse_sample_file(path),
                         jnative.parse_sample_file(path), path)


def test_codec_handles_empty_opt_info(tmp_path):
    sample = {
        "pc1": [[1, 2, 3, 4, 5, 6, 7]], "pc2": [[1, 2, 3, 4, 5, 6, 7]],
        "trans": np.eye(4).tolist(),
        "opt_info": {"radar_u": [], "radar_v": [], "opt_flow": []},
        "gt_mask": [1.0], "gt_labels": [[0, 0, 0]],
        "pse_mask": [1.0], "pse_labels": [[0, 0, 0]],
    }
    path = str(tmp_path / "s.json")
    Path(path).write_text(json.dumps(sample))
    got = codec.parse_sample_file(path)
    assert got["pc1"].shape == (1, 7) and got["opt_info"]["radar_u"].size == 0
    assert_same_tree(got, jnative.parse_sample_file(path))


def test_rejected_file_goes_to_json(tmp_path):
    """A file the codec rejects (ragged rows) is read with ``json``, as the
    JAX reader reads it."""
    path = str(tmp_path / "ragged.json")
    Path(path).write_text(json.dumps({"pc1": [[1, 2], [3]], "trans": []}))
    assert codec.parse_sample_file(path) is None
    got = vod.load_sample_file(path)
    assert got == jvod.load_sample_file(path) == json.loads(
        Path(path).read_text())


def test_codec_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(codec, "SOURCE", broken)
    monkeypatch.setattr(codec, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        codec.build()


def test_reader_uses_the_codec(tree, monkeypatch):
    """``load_sample_file`` returns the codec's float32 arrays, not
    ``json``'s lists."""
    path = sample_files(tree)[0]
    got = vod.load_sample_file(path)
    assert got["trans"].dtype == np.float32
    monkeypatch.setattr(codec, "parse_sample_file", lambda p: None)
    assert isinstance(vod.load_sample_file(path)["trans"], list)


# --------------------------------------------------------------------------
# pack_split and the packed dataset

@pytest.mark.parametrize("partition", ["train", "val", "test"])
def test_pack_split_matches_jax(tree, tmp_path, partition):
    port, ref = str(tmp_path / "port.pack"), str(tmp_path / "jax.pack")
    n = packed.pack_split(tree, partition, port, log=quiet)
    assert n == jpacked.pack_split(tree, partition, ref, log=quiet)
    assert n == {"train": 8, "val": 4, "test": 4}[partition]
    assert Path(port).read_bytes() == Path(ref).read_bytes()
    got = np.load(port + ".idx.npy", allow_pickle=True).item()
    want = np.load(ref + ".idx.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(got["offsets"], want["offsets"])
    assert got["offsets"].dtype == np.int64
    assert got["clips_info"] == want["clips_info"]
    assert sorted(os.listdir(tmp_path)) == [
        "jax.pack", "jax.pack.idx.npy", "port.pack", "port.pack.idx.npy"]


@pytest.fixture(scope="module")
def packs(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("packs")
    paths = {}
    for partition in ("train", "val"):
        paths[partition] = str(out / f"{partition}.pack")
        packed.pack_split(tree, partition, paths[partition], log=quiet)
    return paths


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


MODES = {
    "train": (dict(partition="train", eval_mode=False, seed=7),
              dict(batch_size=3, shuffle=True, drop_last=True, seed=11)),
    "eval_pinned": (dict(partition="val", eval_mode=True),
                    dict(batch_size=4, pad_bucket=64, pad_multiple=64,
                         pad_batch=True, pad_buckets=[64, 128, 256])),
    "eval_multiple": (dict(partition="val", eval_mode=True),
                      dict(batch_size=4, pad_bucket=64, pad_multiple=64,
                           pad_batch=True)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_batches_match_jax_and_json(tree, packs, mode):
    ds_kw, kw = MODES[mode]
    part = ds_kw["partition"]
    common = dict(num_points=64, eval_mode=ds_kw["eval_mode"],
                  seed=ds_kw.get("seed", 1234), log=quiet)
    port = packed.PackedVodDataset(packs[part], part, **common)
    ref = jpacked.PackedVodDataset(packs[part], part, **common)
    js = VodDataset(tree, part, **common)
    assert len(port) == len(ref) == len(js)
    assert port.clips_info == ref.clips_info == js.clips_info
    loaders = [BatchLoader(port, num_workers=0, **kw),
               JaxBatchLoader(ref, num_workers=0, **kw),
               BatchLoader(js, num_workers=0, **kw)]
    for _ in range(2):  # two epochs: the shuffle and the subsamples go on
        want = list(loaders[1])
        assert_batches_equal(loaders[0], want)
        assert_batches_equal(loaders[2], want)


def test_packed_shard_and_plan_match_json(tree, packs):
    """The loader's ``shard=`` rows (each sample's subsample from its own
    generator, ``get``) and a plan, over the packed split and the json
    tree."""
    common = dict(num_points=64, seed=5, log=quiet)
    for rank in range(2):
        kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=3,
                  shard=(rank, 2), num_workers=0)
        pk = BatchLoader(packed.PackedVodDataset(packs["train"], "train",
                                                 **common), **kw)
        js = BatchLoader(VodDataset(tree, "train", **common), **kw)
        for _ in range(2):
            assert_batches_equal(pk, js)
    plan = [{"indices": [0, 3], "lane_valid": [True, True],
             "reset": [True, False]},
            {"indices": [3, 3], "lane_valid": [True, False],
             "reset": [False, False]}]
    kw = dict(batch_size=2, pad_bucket=64, pad_multiple=64, plan=plan,
              num_workers=0)
    pk = packed.PackedVodDataset(packs["val"], "val", eval_mode=True,
                                 **common)
    js = VodDataset(tree, "val", eval_mode=True, **common)
    assert_batches_equal(BatchLoader(pk, **kw), BatchLoader(js, **kw))


def test_packed_eval_drops_the_camera_modality(packs):
    ds = packed.PackedVodDataset(packs["val"], "val", eval_mode=True,
                                 log=quiet)
    assert len(ds.clips_info) == 2
    s = ds[0]
    assert s["pc1"].shape[0] >= 90 and (s["opt_flow"] == 0).all()


def test_bad_pack_file_raises(tmp_path):
    path = tmp_path / "x.pack"
    path.write_bytes(b"NOTAPACK" + bytes(8))
    with pytest.raises(ValueError, match="CMFPACK1"):
        packed.PackedVodDataset(str(path), log=quiet)


def test_cli_trains_on_the_packed_split(tree, tmp_path):
    """``--dataset vodPackedDataset`` through the port's CLI on the CPU:
    each split packed on first use, then read."""
    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("model: cmflow\nnum_points: 64\neval_pad_multiple: 64\n"
                   "data_parallel: false\n")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = climain.main([
            "--config", str(cfg), "--platform", "cpu", "--dataset_path",
            str(root), "--dataset", "vodPackedDataset", "--checkpoints_dir",
            str(tmp_path / "ck"), "--num_workers", "0", "--eval_batch_size",
            "4", "--exp_name", "packed", "--epochs", "1", "--batch_size",
            "4"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    assert (root / "train.pack").is_file() and (root / "val.pack").is_file()
    rows = [json.loads(line)
            for line in open(tmp_path / "ck" / "packed" / "metrics.jsonl")]
    assert [r["phase"] for r in rows] == ["train", "val"]
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k not in ("epoch", "phase", "ts"))


def test_pack_of_preprocessed_samples(tmp_path):
    """The preprocessing writes 5-column clouds (x, y, z, RCS, v_r): the
    port pads them to the format's 7 columns and reads back the json tree's
    batches bit for bit.  The JAX package's ``pack_split`` writes them
    unpadded, and its reader then reads 7 columns a point, other clouds
    than the json tree's (ROADMAP Queue 3)."""
    from cmflow_tpu_torch.preprocess import run_preprocess
    from cmflow_tpu_torch.preprocess.optical_flow import ZeroFlowProvider
    from cmflow_tpu_torch.preprocess.synthetic import write_raw_tree

    splits = {"train": ["delft_2", "delft_3"], "val": ["delft_1"]}
    paths = write_raw_tree(str(tmp_path / "raw"), splits, frames_per_clip=3,
                           image_size=(128, 160),
                           projection=[[40.0, 0.0, 80.0, 0.0],
                                       [0.0, 40.0, 64.0, 0.0],
                                       [0.0, 0.0, 1.0, 0.0]])
    run_preprocess(save_dir=str(tmp_path), splits=splits, log=quiet,
                   opt_provider=ZeroFlowProvider(), **paths)
    smp = str(tmp_path / "flow_smp")
    first = sorted(Path(smp, "train", "delft_2").iterdir())[0]
    assert codec.parse_sample_file(str(first))["pc1"].shape[1] == 5
    for part, eval_mode in (("train", False), ("val", True)):
        pack = str(tmp_path / f"{part}.pack")
        assert packed.pack_split(smp, part, pack, log=quiet) == 2 * len(
            splits[part])
        common = dict(num_points=64, eval_mode=eval_mode, seed=2, log=quiet)
        kw = dict(batch_size=2, num_workers=0, pad_bucket=128,
                  pad_batch=eval_mode, drop_last=not eval_mode)
        assert_batches_equal(
            BatchLoader(packed.PackedVodDataset(pack, part, **common), **kw),
            BatchLoader(VodDataset(smp, part, **common), **kw))
    jax_pack = str(tmp_path / "jax.pack")
    jpacked.pack_split(smp, "val", jax_pack, log=quiet)
    assert Path(jax_pack).stat().st_size < Path(
        tmp_path / "val.pack").stat().st_size
    jax_sample = jpacked.PackedVodDataset(jax_pack, "val", eval_mode=True,
                                          log=quiet)[0]
    want = VodDataset(smp, "val", eval_mode=True, log=quiet)[0]
    assert not np.array_equal(jax_sample["pc1"], want["pc1"])
