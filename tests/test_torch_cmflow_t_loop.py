"""Port parity: the experiment loop's paths for CMFlow_T and RaFlow on the
CPU: ``VodClipDataset``, the loader's plan mode, ``build_clip_plan`` and
``reset_lanes`` against the JAX package's on the same synthetic tree (batches
bit for bit), ``evaluate_frames`` against the JAX package's from the same
weights (CMFlow_T on its lane plan, RaFlow frame-pair) at the metric bars of
tests/test_torch_loop.py (the flow metrics 1e-4, the pose metrics 5e-4, the
rates 0.01), and a ``main([...])`` train, resume and evaluation per family.

The tree: train one clip of 10 frames (two mini-clips of 5), val three
clips of 3, 2 and 3 frames, test one clip of 3, each frame of 40-59
points, so every eval batch pads to the 64 bucket.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.data import BatchLoader as JaxBatchLoader
from cmflow_tpu.data import VodClipDataset as JaxVodClipDataset
from cmflow_tpu.data import VodDataset as JaxVodDataset
from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.train import loop as jloop
from cmflow_tpu.train.state import TrainState as JaxTrainState
from cmflow_tpu.train.state import make_optimizer as jax_make_optimizer
from cmflow_tpu.utils import config as jconfig
from cmflow_tpu_torch.cli import main as climain
from cmflow_tpu_torch.data import (
    DATASET_REGISTRY,
    BatchLoader,
    VodClipDataset,
    VodDataset,
)
from cmflow_tpu_torch.data.synthetic import write_synthetic_dataset
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.train import loop
from cmflow_tpu_torch.utils import config
from test_torch_loop import (
    POSE_KEYS,
    RATE_KEYS,
    SF_KEYS,
    _Quiet,
    assert_batches_equal,
    jax_json_reader,  # noqa: F401 (a fixture)
)

UPDATE_LEN = 2
QUIET = dict(log=lambda text: None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clips"))
    write_synthetic_dataset(root, {"train": 10}, clips_per_partition=1,
                            seed=2, n_range=(40, 60))
    write_synthetic_dataset(root, {"val": 9}, clips_per_partition=3,
                            seed=3, n_range=(40, 60))
    write_synthetic_dataset(root, {"test": 3}, clips_per_partition=1,
                            seed=4, n_range=(40, 60))
    clip = os.path.join(root, "val", "delft_2")
    os.remove(os.path.join(clip, sorted(os.listdir(clip))[-1]))
    return root


def clip_datasets(tree, partition, eval_mode, **kw):
    kw = dict(num_points=64, eval_mode=eval_mode, mini_clip_len=5,
              update_len=UPDATE_LEN, seed=7, **QUIET, **kw)
    return (VodClipDataset(tree, partition, **kw),
            JaxVodClipDataset(tree, partition, **kw))


# --------------------------------------------------------------------------
# dataset, loader, plan

def test_registry_and_clip_dataset(tree):
    assert DATASET_REGISTRY["vodClipDataset"] is VodClipDataset
    for eval_mode, partition in ((False, "train"), (True, "val")):
        port, ref = clip_datasets(tree, partition, eval_mode)
        assert len(port) == len(ref)
        assert port.samples == ref.samples
        assert port.mini_samples == ref.mini_samples
        assert port.clips_info == ref.clips_info
    port, _ = clip_datasets(tree, "val", True)
    assert [c["index"] for c in port.clips_info] == [[0, 3], [3, 5], [5, 8]]
    train, _ = clip_datasets(tree, "train", False)
    assert len(train) == 2 and train[0]["pc1"].shape == (5, 64, 3)


def test_clip_batches_match_jax(tree, jax_json_reader):  # noqa: F811
    port, ref = clip_datasets(tree, "train", False)
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=11,
              num_workers=0)
    loaders = BatchLoader(port, **kw), JaxBatchLoader(ref, **kw)
    for _ in range(2):  # the shuffle and the subsamples go on
        assert_batches_equal(*loaders)
    batch = next(iter(loaders[0]))
    assert batch["pc1"].shape == (2, 5, 64, 3)
    assert batch["interval"].shape == (2, 5)


@pytest.mark.parametrize("lanes", [1, 2, 3, 5])
def test_build_clip_plan_matches_jax(tree, lanes):
    port, _ = clip_datasets(tree, "val", True)
    plan = loop.build_clip_plan(port.clips_info, lanes, UPDATE_LEN)
    assert plan == jloop.build_clip_plan(port.clips_info, lanes, UPDATE_LEN)
    # every frame once, each lane in clip order, the reference's resets
    seen = [(i, r) for e in plan for i, v, r in
            zip(e["indices"], e["lane_valid"], e["reset"]) if v]
    assert sorted(i for i, _ in seen) == list(range(8))
    starts = {c["index"][0] for c in port.clips_info}
    assert all(r == (i in starts or i % UPDATE_LEN == 0) for i, r in seen)


def test_plan_batches_match_jax(tree, jax_json_reader):  # noqa: F811
    port, ref = clip_datasets(tree, "val", True)
    plan = loop.build_clip_plan(port.clips_info, 2, UPDATE_LEN)
    kw = dict(batch_size=2, pad_bucket=64, pad_multiple=64,
              pad_buckets=[64, 256], plan=plan)
    got = list(BatchLoader(port, num_workers=0, **kw))
    # lane 0 takes the clip of 3 frames, lane 1 those of 2 and 3
    assert len(got) == len(BatchLoader(port, num_workers=0, **kw)) == 5
    assert_batches_equal(got, JaxBatchLoader(ref, num_workers=0, **kw))
    assert_batches_equal(BatchLoader(port, num_workers=2, **kw),
                         JaxBatchLoader(ref, num_workers=0, **kw))
    assert [b["lane_valid"].tolist() for b in got[2:]] == [
        [True, True], [False, True], [False, True]]
    assert [b["_frame_idx"].tolist() for b in got] == [
        e["indices"] for e in plan]


def test_reset_lanes_matches_jax():
    rs = np.random.RandomState(0)
    g = rs.randn(4, 8).astype(np.float32)
    reset = np.array([True, False, False, True])
    got = loop.reset_lanes(torch.from_numpy(g), torch.from_numpy(reset))
    want = jloop._reset_lanes(jnp.asarray(g), jnp.asarray(reset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# evaluate_frames against the JAX package's

def configs(tree, tmp_path, model, **kw):
    base = dict(model=model, num_points=64, eval_pad_multiple=64,
                num_workers=0, data_parallel=False, dataset_path=tree,
                update_len=UPDATE_LEN, eval_wire="float32",
                dataset=("vodClipDataset" if model == "cmflow_t"
                         else "vodDataset"), **kw)
    port = config.Config(exp_name="t", platform="cpu",
                         checkpoints_dir=str(tmp_path / "ck"), **base)
    return port, jconfig.Config(**base)


def jax_state(port_model):
    v = jax.tree_util.tree_map(jnp.asarray, export_flax_variables(port_model))
    tx = jax_make_optimizer()
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"],
                         opt_state=tx.init(v["params"]), tx=tx)


def merged(result):
    return {k: v for d in result for k, v in d.items()}


def assert_metrics_close(got, want):
    got, want = merged(got), merged(want)
    assert sorted(got) == sorted(want)
    for k in SF_KEYS:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    for k in POSE_KEYS:
        assert abs(got[k] - want[k]) <= 5e-4, (k, got[k], want[k])
    for k in RATE_KEYS:
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])


@pytest.mark.parametrize("model_name,lanes", [("cmflow_t", 2),
                                              ("raflow", 4)])
def test_evaluate_frames_matches_jax(tree, tmp_path, model_name, lanes):
    """CMFlow_T on two lanes over three clips (one lane takes two clips,
    the other runs out two steps early); RaFlow at four frames a batch."""
    cfg, jcfg = configs(tree, tmp_path, model_name, eval_batch_size=lanes)
    model = build_model(model_name, "cpu", seed=5)
    ds_cls, jds_cls = ((VodClipDataset, JaxVodClipDataset)
                       if model_name == "cmflow_t"
                       else (VodDataset, JaxVodDataset))
    kw = dict(update_len=UPDATE_LEN) if model_name == "cmflow_t" else {}
    want = jloop.evaluate_frames(
        jcfg, jax_build_model(model_name, jcfg), jax_state(model),
        jds_cls(tree, "val", 64, True, **QUIET, **kw), _Quiet())
    got = loop.evaluate_frames(cfg, model,
                               ds_cls(tree, "val", 64, True, **QUIET, **kw),
                               _Quiet())
    assert_metrics_close(got, want)
    assert np.isfinite(merged(got)["rne"])


def test_lane_plan_equals_the_frame_walk(tree, tmp_path):
    """The lanes reproduce the reference's one-frame-a-batch walk: the same
    resets, so the same predictions up to batching, and the same dumps."""
    model = build_model("cmflow_t", "cpu", seed=5)
    ds = VodClipDataset(tree, "val", 64, True, update_len=UPDATE_LEN,
                        **QUIET)
    dumps = {}
    for lanes in (1, 3):
        cfg, _ = configs(tree, tmp_path, "cmflow_t", eval_batch_size=lanes)
        out = str(tmp_path / f"res{lanes}")
        dumps[lanes] = (merged(loop.evaluate_frames(
            cfg, model, ds, _Quiet(), save_res_dir=out)), out)
    (one, out1), (three, out3) = dumps[1], dumps[3]
    for k in one:
        assert abs(one[k] - three[k]) <= 1e-5, (k, one[k], three[k])
    names = sorted(os.path.relpath(os.path.join(d, f), out1)
                   for d, _, fs in os.walk(out1) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), out3)
                           for d, _, fs in os.walk(out3) for f in fs)
    assert len(names) == 8 and "delft_2/4.json" in names
    for name in names:
        a = json.load(open(os.path.join(out1, name)))
        b = json.load(open(os.path.join(out3, name)))
        np.testing.assert_allclose(a["pred_f"], b["pred_f"], atol=1e-5)
        assert a["pc1"] == b["pc1"]


# --------------------------------------------------------------------------
# the CLI

@pytest.mark.parametrize("model_name", ["cmflow_t", "raflow"])
def test_cli_train_resume_eval(tree, tmp_path, capsys, model_name):
    dataset = "vodClipDataset" if model_name == "cmflow_t" else "vodDataset"
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(f"model: {model_name}\ndataset: {dataset}\n"
                        f"num_points: 64\neval_pad_multiple: 64\n"
                        f"data_parallel: false\nupdate_len: {UPDATE_LEN}\n")
    common = ["--config", str(cfg_path), "--platform", "cpu",
              "--dataset_path", tree, "--checkpoints_dir",
              str(tmp_path / "ck"), "--num_workers", "0",
              "--eval_batch_size", "2", "--batch_size", "2"]
    assert climain.main(common + ["--exp_name", "tr", "--epochs", "1"]) == 0
    exp = tmp_path / "ck" / "tr"
    rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["phase"] for r in rows] == ["train", "val"]
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k not in ("phase", "ts"))
    last = str(exp / "models" / "last")
    saved = torch.load(last, map_location="cpu", weights_only=True)
    # cmflow_t: one batch of two 5-frame mini-clips, one step per frame;
    # raflow: five batches of two frames
    assert saved["step"] == 5
    assert climain.main(common + ["--exp_name", "re", "--epochs", "1",
                                  "--load_checkpoint", "--model_path",
                                  last]) == 0
    resumed = torch.load(str(tmp_path / "ck" / "re" / "models" / "last"),
                         map_location="cpu", weights_only=True)
    assert resumed["step"] == 10
    # the staircase counts clip batches (one a epoch) for cmflow_t, so its
    # learning rate decays once per optimizer update
    decays = 10 if model_name == "cmflow_t" else 2
    assert resumed["optimizer"]["param_groups"][0]["lr"] == pytest.approx(
        1e-3 * 0.9 ** decays)
    capsys.readouterr()
    assert climain.main(common + ["--exp_name", "ev", "--eval", "--save_res",
                                  "--model_path", last]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint from" in out and "###The mean rne:" in out
    dumped = sorted(f for _, _, fs in os.walk(tmp_path / "ck" / "ev")
                    for f in fs if f.endswith(".json") and f[0].isdigit())
    assert dumped == ["0.json", "1.json", "2.json"]
