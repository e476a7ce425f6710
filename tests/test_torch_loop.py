"""Port parity: the experiment loop of ``cmflow_tpu_torch`` (config, dataset
tree, loader, eval wire, device metrics, checkpoint and resume,
``evaluate_frames``, the CLI) against the JAX package's, on the CPU.

Bars: the config, the dataset tree, the loader's batches and the int16 wire
are held equal bit for bit.  The device metrics within 1e-5 abs of the JAX
battery's (both float32), and within the JAX package's own device-vs-host bar
(rtol 2e-4, atol 2e-5, tests/test_metrics.py) of the host battery.  The
checkpoint round trip and the resume are exact.  ``evaluate_frames`` from the
same converted weights: the RNE family and EPE within 1e-4 abs, RTE and RAE
within 5e-4, and the rates (sas, ras, accs, accr, acc, miou, sen) within 0.01,
the >= 99% mask agreement bar of the fused engines.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

from cmflow_tpu.data import BatchLoader as JaxBatchLoader
from cmflow_tpu.data import VodDataset as JaxVodDataset
from cmflow_tpu.data.synthetic import (
    write_synthetic_dataset as jax_write_synthetic_dataset,
)
from cmflow_tpu.evaluation import device_metrics as jdm
from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.train import loop as jloop
from cmflow_tpu.utils import config as jconfig
from cmflow_tpu_torch.cli import main as climain
from cmflow_tpu_torch.data import DATASET_REGISTRY, BatchLoader, VodDataset
from cmflow_tpu_torch.data.synthetic import (
    make_train_batch,
    write_synthetic_dataset,
)
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.evaluation import device_metrics as dm
from cmflow_tpu_torch.evaluation import metrics as host_metrics
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.train import loop, steps
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.utils import config

CONFIGS = ("configs/cmflow.yaml", "configs/raflow.yaml",
           "configs/cmflow_t.yaml")
SF_KEYS = ("rne", "50-50 rne", "mov_rne", "stat_rne", "epe")
POSE_KEYS = ("RTE", "RAE")
RATE_KEYS = ("sas", "ras", "accs", "accr", "acc", "miou", "sen")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Quiet:
    def cprint(self, text):
        pass


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One tiny synthetic tree (frames of 90-129 points), as the JAX loop's
    tests use."""
    root = str(tmp_path_factory.mktemp("tree"))
    write_synthetic_dataset(root, {"train": 6, "val": 5, "test": 3},
                            clips_per_partition=1, seed=1, n_range=(90, 130))
    return root


def tiny_cfg(tree, tmp_path, **kw):
    base = dict(exp_name="t", dataset_path=tree, epochs=1, batch_size=2,
                num_points=64, num_workers=0, eval_batch_size=4,
                checkpoints_dir=str(tmp_path / "ckpt"), data_parallel=False,
                eval_pad_multiple=64, platform="cpu")
    base.update(kw)
    return config.Config(**base)


# --------------------------------------------------------------------------
# config

@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_jax(path):
    overrides = {"exp_name": "x", "epochs": None, "lr": 0.01,
                 "eval_wire": "float32", "batch_size": 4}
    for ov in (None, overrides):
        got = dataclasses.asdict(config.load_config(path, ov))
        want = dataclasses.asdict(jconfig.load_config(path, ov))
        assert got == want


def test_load_config_unknown_key(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("not_a_key: 1\n")
    with pytest.raises(KeyError):
        config.load_config(str(p))
    with pytest.raises(KeyError):
        config.load_config(None, {"not_a_key": 1})


@pytest.mark.parametrize("text", [
    "a: 1", "a: -3", "a: 0", "a: 0.5", "a: 1.", "a: .25", "a: 1.0e-3",
    "a: -2.5E+2", "a: true", "a: False", "a: TRUE", "a: cmflow",
    "a: 2026_run", "a: +.5", "a: hello world", "a: 'quoted # not a comment'",
    'a: "double"', "a: 'it''s'", "a: x # comment", "# only a comment\na: 1",
    "a: 1 # trailing\nb: 2.0\n\nc: name",
])
def test_flat_yaml_matches_pyyaml(text):
    assert config.parse_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e-3", "a: yes", "a: off", "a: null", "a: ~", "a:", "a: 010",
    "a: 0x1f", "a: 1_000", "a: 1:30", "a: .inf", "a: [1, 2]", "a: {b: 1}",
    "a: &x 1", "a: *x", "a: !!str 1", "a: |", "a:\n  b: 1", "- 1",
    "a: b: c", 'a: "esc\\n"', "a: 1\na: 2", "a:1",
])
def test_flat_yaml_rejects_the_rest(text):
    with pytest.raises(ValueError):
        config.parse_flat_yaml(text)


@pytest.mark.parametrize("field,value", [
    ("compute_dtype", "bfloat16"), ("eval_compute_dtype", "bfloat16"),
    ("remat", True), ("vis", True), ("profile_dir", "/tmp/p"),
    ("nan_check", True),
])
def test_unported_fields_raise(field, value):
    """The fields that once raised ``NotImplementedError`` are all ported
    now: each loads the JAX package's value, and a value outside a field's
    choices raises ``ValueError`` (a dtype outside float32 and bfloat16, a
    ``remat`` outside False, True and "dots", as ``remat_wrap`` raises)."""
    assert getattr(config.Config(**{field: value}), field) == value
    jax_value = getattr(jconfig.Config(**{field: value}), field)
    assert jax_value == value
    bad = {"compute_dtype": "float16", "eval_compute_dtype": "float16",
           "remat": "dot"}.get(field)
    if bad is not None:
        with pytest.raises(ValueError, match=field):
            config.Config(**{field: bad})


def test_platform_choices():
    with pytest.raises(ValueError):
        config.Config(platform="tpu")
    assert config.config_device(config.Config(platform="cpu")).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            config.config_device(config.Config())


# --------------------------------------------------------------------------
# dataset tree, reader and loader

def test_write_synthetic_dataset_matches_jax(tmp_path):
    parts = {"train": 4, "val": 2, "test": 3}
    write_synthetic_dataset(str(tmp_path / "port"), parts,
                            clips_per_partition=2, seed=3)
    jax_write_synthetic_dataset(str(tmp_path / "jax"), parts,
                                clips_per_partition=2, seed=3)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(tmp_path / "port")
    assert names == files(tmp_path / "jax") and len(names) == 8
    for name in names:
        with open(tmp_path / "port" / name) as a, \
                open(tmp_path / "jax" / name) as b:
            assert json.load(a) == json.load(b), name


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("mode", ["train", "eval_pinned", "eval_multiple"])
def test_loader_batches_match_jax(tree, mode):
    """Against the JAX package's default reader: both parse the samples
    with the C++ codec, straight to float32."""
    if mode == "train":
        ds = dict(partition="train", num_points=64, eval_mode=False, seed=7)
        kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=11)
    else:
        ds = dict(partition="val", num_points=64, eval_mode=True)
        kw = dict(batch_size=4, pad_bucket=64, pad_multiple=64,
                  pad_batch=True)
        if mode == "eval_pinned":
            kw["pad_buckets"] = [64, 128, 256]
    port = VodDataset(tree, log=lambda s: None, **ds)
    ref = JaxVodDataset(tree, log=lambda s: None, **ds)
    assert port.samples == ref.samples and port.clips_info == ref.clips_info
    loaders = (BatchLoader(port, num_workers=0, **kw),
               JaxBatchLoader(ref, num_workers=0, **kw))
    assert len(loaders[0]) == len(loaders[1])
    for _ in range(2):  # two epochs: the shuffle and the subsamples go on
        assert_batches_equal(*loaders)
    if mode != "train":  # eval draws nothing: the prefetch threads agree
        assert_batches_equal(BatchLoader(port, num_workers=2, **kw),
                             JaxBatchLoader(ref, num_workers=0, **kw))
        batch = next(iter(loaders[0]))
        assert batch["lane_valid"].tolist() == [True] * 4


def test_loader_fails_above_the_top_bucket(tree):
    port = VodDataset(tree, "val", eval_mode=True, log=lambda s: None)
    for cls in (BatchLoader, JaxBatchLoader):
        loader = cls(port, batch_size=2, pad_buckets=[64], num_workers=0)
        with pytest.raises(ValueError, match="bucket"):
            next(iter(loader))


def test_build_model_takes_stat_thres():
    model = build_model("cmflow", "cpu", stat_thres=0.3)
    assert model.stat_thres == 0.3
    assert build_model("cmflow", "cpu").stat_thres == 0.5


def test_dataset_registry(tree, tmp_path):
    from cmflow_tpu_torch.data import (
        PackedVodDataset,
        VodClipDataset,
        packed_vod_dataset,
    )

    assert DATASET_REGISTRY["vodDataset"] is VodDataset
    assert DATASET_REGISTRY["vodClipDataset"] is VodClipDataset
    assert DATASET_REGISTRY["vodPackedDataset"] is packed_vod_dataset
    # packed from the json tree on first use, beside it
    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    ds = DATASET_REGISTRY["vodPackedDataset"](str(root), "val",
                                              eval_mode=True,
                                              log=lambda s: None)
    assert isinstance(ds, PackedVodDataset) and len(ds) == 5
    assert (root / "val.pack").is_file()


# --------------------------------------------------------------------------
# the eval wire

@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_eval_wire_matches_jax(wire):
    rng = np.random.RandomState(2)
    batch = {
        "pc1": (rng.randn(4, 16, 3) * 30).astype(np.float32),
        "mask": (rng.rand(4, 40) > 0.5).astype(np.float32),
        "valid1": rng.rand(4, 40) > 0.5,
        "interval": rng.rand(4).astype(np.float32),
        "trans": rng.randn(4, 4, 4).astype(np.float32),
        "zeros": np.zeros((4, 64), np.float32),
        "outlier": np.concatenate(
            [rng.randn(3, 33), 1e4 * rng.randn(1, 33)]).astype(np.float32),
    }
    got = loop.upload_eval_batch(
        loop.pack_eval_batch(batch, wire, pin=False), torch.device("cpu"))
    want = jloop._to_device_packed(batch, None, wire=wire)
    assert sorted(got) == sorted(want)
    changed = set()
    for k, v in batch.items():
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
        if not np.array_equal(g, v):
            changed.add(k)
    # 0/1 masks and zeros come back exact; trans and interval are too narrow
    assert changed == ({"pc1", "outlier"} if wire == "int16" else set())


# --------------------------------------------------------------------------
# device metrics

def random_frames(rng, b=8, n=96):
    from scipy.spatial.transform import Rotation

    pc = (rng.rand(b, n, 3) * 20 + 1).astype(np.float32)
    pred = (rng.randn(b, n, 3) * 0.4).astype(np.float32)
    gt = (rng.randn(b, n, 3) * 0.4).astype(np.float32)
    mask = (rng.rand(b, n) > 0.4).astype(np.float32)
    pred_m = rng.rand(b, n) > 0.5
    nv = rng.randint(8, n + 1, size=b)
    valid = np.arange(n)[None, :] < nv[:, None]
    pc[~valid] = 0.0

    def rand_t():
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = Rotation.from_euler("xyz", rng.randn(3) * 0.2).as_matrix()
        t[:3, 3] = rng.randn(3)
        return t

    gt_t = np.stack([rand_t() for _ in range(b)])
    pr_t = np.stack([rand_t() for _ in range(b)])
    # one near-identity relative pose: the small-angle end of the RPE angle
    pr_t[0] = gt_t[0]
    pr_t[0, 0, 3] += 1e-3
    return pc, pred, gt, mask, valid, gt_t, pr_t, pred_m


def test_frame_metrics_match_jax_and_host():
    args = random_frames(np.random.RandomState(5))
    got = dm.frame_metrics(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jdm.frame_metrics(*(jnp.asarray(a) for a in args)))
    assert got.shape == (8, len(dm.METRIC_KEYS)) and got.dtype == np.float32
    assert dm.METRIC_KEYS == jdm.METRIC_KEYS
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    pc, pred, gt, mask, valid, gt_t, pr_t, pred_m = args
    host = {**host_metrics.eval_scene_flow_batch(pc, pred, gt, mask, valid),
            **host_metrics.eval_motion_seg_batch(pred_m.astype(np.float32),
                                                 mask, valid),
            **host_metrics.eval_trans_rpe_batch(gt_t, pr_t)}
    for j, k in enumerate(dm.METRIC_KEYS):
        np.testing.assert_allclose(got[:, j], host[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_accumulate_matches_jax():
    rng = np.random.RandomState(6)
    vec = rng.rand(5, 14).astype(np.float32)
    keep = np.array([True, False, True, True, False])
    sums = rng.rand(14).astype(np.float32)
    got = dm.accumulate(torch.from_numpy(sums), torch.tensor(2.0),
                        torch.from_numpy(vec), torch.from_numpy(keep))
    want = jdm.accumulate(jnp.asarray(sums), jnp.asarray(2.0),
                          jnp.asarray(vec), jnp.asarray(keep))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    assert float(got[1]) == float(want[1]) == 5.0
    # a dropped lane adds nothing, not even a nan
    vec[1] = np.nan
    got = dm.accumulate(torch.from_numpy(sums), torch.tensor(2.0),
                        torch.from_numpy(vec), torch.from_numpy(keep))
    assert np.isfinite(got[0].numpy()).all()


# --------------------------------------------------------------------------
# checkpoint and resume

def snapshot(state):
    """Every bit of a train state, on the host."""
    opt = state.optimizer.state_dict()
    return dict(
        model={k: v.clone() for k, v in state.model.state_dict().items()},
        moments={(i, k): v.clone() for i, s in opt["state"].items()
                 for k, v in s.items()},
        groups=[{k: v for k, v in g.items() if k != "params"}
                for g in opt["param_groups"]],
        scheduler=state.scheduler.state_dict(), step=state.step)


def assert_same_bits(a, b):
    assert sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert sorted(a["moments"]) == sorted(b["moments"])
    for k in a["moments"]:
        assert a["moments"][k].device == b["moments"][k].device, k
        assert torch.equal(a["moments"][k], b["moments"][k]), k
    assert a["groups"] == b["groups"]
    assert a["scheduler"] == b["scheduler"] and a["step"] == b["step"]


def new_state(seed):
    model = build_model("cmflow", "cpu", seed=seed)
    return create_train_state(model, steps_per_epoch=2, lr=1e-3,
                              decay_rate=0.5)


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """Three train steps, a checkpoint, then two more: the states and
    learning rates on the way."""
    path = str(tmp_path_factory.mktemp("ck") / "last")
    batches = [make_train_batch(s, 2, 64) for s in range(5)]
    state = new_state(0)
    step = steps.make_train_step("cmflow", state.model, VOD_CAMERA_PROJECTION,
                                 VOD_T_CAMERA_RADAR)
    for batch in batches[:3]:
        step(state, batch)
    loop.save_checkpoint(path, state)
    saved = snapshot(state)
    lrs = []
    for batch in batches[3:]:
        lrs.append(state.optimizer.param_groups[0]["lr"])
        step(state, batch)
    return dict(path=path, batches=batches, saved=saved, lrs=lrs,
                after=snapshot(state))


def test_checkpoint_round_trip(train_run):
    state = loop.restore_checkpoint(train_run["path"], new_state(9))
    assert_same_bits(snapshot(state), train_run["saved"])
    assert state.step == 3
    for s in state.optimizer.state.values():
        assert s["step"].device.type == "cpu" and float(s["step"]) == 3.0


def test_resume_continues_the_run(train_run):
    state = loop.restore_checkpoint(train_run["path"], new_state(9))
    step = steps.make_train_step("cmflow", state.model, VOD_CAMERA_PROJECTION,
                                 VOD_T_CAMERA_RADAR)
    lrs = []
    for batch in train_run["batches"][3:]:
        lrs.append(state.optimizer.param_groups[0]["lr"])
        step(state, batch)
    # staircase: steps 0-1 at lr, 2-3 at lr/2, 4 at lr/4
    assert lrs == train_run["lrs"] == [5e-4, 2.5e-4]
    assert_same_bits(snapshot(state), train_run["after"])


def test_evaluate_frames_leaves_the_train_state(tree, tmp_path, train_run):
    state = loop.restore_checkpoint(train_run["path"], new_state(9))
    before = snapshot(state)
    cfg = tiny_cfg(tree, tmp_path)
    for save_res_dir in (None, str(tmp_path / "res")):
        sf, _, _ = loop.evaluate_frames(cfg, state.model,
                                        VodDataset(tree, "val", 64, True,
                                                   log=lambda s: None),
                                        _Quiet(), save_res_dir=save_res_dir)
        assert np.isfinite(sf["rne"])
    assert_same_bits(snapshot(state), before)


# --------------------------------------------------------------------------
# the slice as a whole: evaluate_frames against the JAX package's

@pytest.fixture(scope="module")
def jax_and_port_models(tree):
    jcfg = jconfig.Config(num_points=64, eval_pad_multiple=64,
                          eval_batch_size=4, num_workers=0,
                          data_parallel=False, dataset_path=tree)
    jmodel = jax_build_model("cmflow", jcfg)
    first = next(iter(JaxBatchLoader(
        JaxVodDataset(tree, "train", 64, log=lambda s: None), 2,
        drop_last=True, num_workers=0)))
    example = {k: jnp.asarray(v) for k, v in first.items()}
    example["_steps_per_epoch"] = 3
    # the loop's state, its variables drawn by one jitted init (the loop's
    # own init runs op by op, ~30 s on the CPU)
    jstate = jloop.init_model_state(jcfg, jmodel, None, dict(example),
                                    abstract=True)
    inputs = [example[k] for k in ("pc1", "pc2", "ft1", "ft2", "mask")]
    variables = jax.jit(lambda key: jmodel.init({"params": key}, *inputs,
                                                True))(
        jax.random.PRNGKey(jcfg.seed))
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    model = build_model("cmflow", "cpu")
    load_flax_variables(model, jax.tree_util.tree_map(
        np.asarray, unfreeze(variables)))
    jstep = jloop.make_experiment_eval_step(jcfg, jmodel)
    return jcfg, jmodel, jstate, jstep, model


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_evaluate_frames_matches_jax(tree, tmp_path, jax_and_port_models,
                                     wire):
    jcfg, jmodel, jstate, jstep, model = jax_and_port_models
    jcfg = jcfg.replace(eval_wire=wire)
    cfg = tiny_cfg(tree, tmp_path, eval_wire=wire)
    # 5 val frames at eval_batch_size 4: one full batch, one padded
    want = jloop.evaluate_frames(
        jcfg, jmodel, jstate,
        JaxVodDataset(tree, "val", 64, True, log=lambda s: None), _Quiet(),
        eval_step=jstep)
    got = loop.evaluate_frames(
        cfg, model, VodDataset(tree, "val", 64, True, log=lambda s: None),
        _Quiet())
    got, want = ({k: v for d in r for k, v in d.items()} for r in (got, want))
    assert sorted(got) == sorted(want)
    for k in SF_KEYS:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    for k in POSE_KEYS:
        assert abs(got[k] - want[k]) <= 5e-4, (k, got[k], want[k])
    for k in RATE_KEYS:
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])


# --------------------------------------------------------------------------
# the CLI

def test_cli_train_then_eval(tree, tmp_path, monkeypatch, capsys):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text("model: cmflow\nnum_points: 64\n"
                        "eval_pad_multiple: 64\ndata_parallel: false\n")
    common = ["--config", str(cfg_path), "--platform", "cpu",
              "--dataset_path", tree, "--checkpoints_dir",
              str(tmp_path / "ck"), "--num_workers", "0",
              "--eval_batch_size", "4"]
    calls = []
    real = steps.make_eval_step

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(steps, "make_eval_step", counting)
    assert climain.main(common + ["--exp_name", "tr", "--epochs", "2",
                                  "--batch_size", "2"]) == 0
    assert len(calls) == 1  # one eval step for both validation passes
    exp = tmp_path / "ck" / "tr"
    log = (exp / "run.log").read_text()
    assert log.count("mean RNE score") == 2 and "frames/s" in log
    rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [(r["epoch"], r["phase"]) for r in rows] == [
        (0, "train"), (0, "val"), (1, "train"), (1, "val")]
    assert all(np.isfinite(r["Loss"]) for r in rows if r["phase"] == "train")
    assert os.path.isfile(exp / "models" / "best")
    assert os.path.isfile(exp / "models" / "last")
    assert capsys.readouterr().out.rstrip().endswith("FINISH")

    assert climain.main(common + ["--exp_name", "ev", "--eval", "--save_res",
                                  "--model_path",
                                  str(exp / "models" / "best")]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint from" in out and "###The mean rne:" in out
    results = tmp_path / "ck" / "ev" / "results"
    dumped = sorted(f for _, _, fs in os.walk(results) for f in fs)
    assert dumped == ["0.json", "1.json", "2.json"]  # one per test frame
    d = json.load(open(results / "delft_1" / "0.json"))
    assert len(d["pc1"]) == 3 and len(d["pred_f"]) == 3
    assert np.array(d["pred_t"]).shape == (4, 4)
    assert len(d["pred_m"]) == len(d["pc1"][0])

    if not torch.cuda.is_available():  # the CLI runs on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            climain.main(common[:2] + common[4:] + ["--exp_name", "nocard"])
