"""Port parity: the offline preprocessing of ``cmflow_tpu_torch`` (the raw
VoD readers, the MOT boxes, the sample builder, the RAFT-small provider and
the CLI) against the JAX package's ``cmflow_tpu.preprocess``, on the CPU.

The raw trees are synthetic (``preprocess/synthetic.py``, built as
``tests/test_preprocess.py`` builds one): a static world, a radar moving
forward, one object with a motion of its own.  Bars:

* host code, and every sample field without camera flow: equal, value for
  value (the same numpy arithmetic on the same files);
* ``opt_flow`` from RAFT-small on weights both sides load from one
  ``raft-small.pth``: within 1e-2 px (``tests/test_preprocess.py:352``);
* the port's CLI against the port's own ``run_preprocess``: equal.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from cmflow_tpu.preprocess import boxes as jboxes
from cmflow_tpu.preprocess import flow_samples as jflow
from cmflow_tpu.preprocess import optical_flow as jopt
from cmflow_tpu.preprocess import vod_io as jvod_io
from cmflow_tpu_torch.cli import preprocess as cli
from cmflow_tpu_torch.models import raft
from cmflow_tpu_torch.preprocess import (
    SCENE_FLOW_SPLITS,
    boxes,
    build_sample,
    flow_samples,
    optical_flow,
    process_clip,
    run_preprocess,
    vod_io,
)
from cmflow_tpu_torch.preprocess.synthetic import write_raw_tree

FLOW_ATOL = 1e-2  # px
SPLITS = {"train": ["delft_2", "delft_3"], "val": ["delft_1"],
          "test": ["delft_4"]}
# a camera that keeps every projection inside a 128x160 image, so RAFT runs
# at a size the CPU affords
SMALL_IMAGE = (128, 160)
SMALL_PROJECTION = [[40.0, 0.0, 80.0, 0.0], [0.0, 40.0, 64.0, 0.0],
                    [0.0, 0.0, 1.0, 0.0]]


def quiet(*args):
    pass


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw_small"))
    return write_raw_tree(root, SPLITS, frames_per_clip=3,
                          image_size=SMALL_IMAGE,
                          projection=SMALL_PROJECTION)


@pytest.fixture(scope="module")
def vod_tree(tmp_path_factory):
    """VoD's camera and image size, one clip a split."""
    root = str(tmp_path_factory.mktemp("raw_vod"))
    return write_raw_tree(root, {k: v[:1] for k, v in SPLITS.items()},
                          frames_per_clip=3, seed=1)


@pytest.fixture(scope="module")
def raft_pth(tmp_path_factory):
    """A ``raft-small.pth`` in the public layout, from seeded weights."""
    model = raft.RaftSmall()
    raft.init_raft_small(model, torch.Generator().manual_seed(2))
    path = str(tmp_path_factory.mktemp("weights") / "raft-small.pth")
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               path)
    return path


def read_tree(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f)) as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = json.load(fh)
    return out


# --------------------------------------------------------------------------
# host helpers

@pytest.mark.parametrize("frame", ["00000", "00004"])
def test_frame_readers_match_jax(small_tree, frame):
    loc = vod_io.VodLocations(root_dir=small_tree["root_dir"])
    jloc = jvod_io.VodLocations(root_dir=small_tree["root_dir"])
    fr, jfr = vod_io.VodFrame(loc, frame), jvod_io.VodFrame(jloc, frame)
    np.testing.assert_array_equal(fr.radar_data, jfr.radar_data)
    np.testing.assert_array_equal(fr.image, jfr.image)
    assert fr.image.shape == (*SMALL_IMAGE, 3)
    tf, jtf = (vod_io.FrameTransforms(loc, frame),
               jvod_io.FrameTransforms(jloc, frame))
    for name in ("camera_projection_matrix", "t_camera_radar",
                 "t_radar_lidar", "t_odom_camera", "t_camera_odom"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jtf, name))
    proj = tf.camera_projection_matrix
    np.testing.assert_array_equal(
        vod_io.filt_points_in_fov(fr.radar_data, tf.t_camera_radar, proj),
        jvod_io.filt_points_in_fov(jfr.radar_data, jtf.t_camera_radar, proj))
    np.testing.assert_array_equal(
        vod_io.filt_points_by_height(fr.radar_data, -0.2, 1.0),
        jvod_io.filt_points_by_height(jfr.radar_data, -0.2, 1.0))


def test_ego_and_rigid_flow_match_jax(small_tree):
    loc = vod_io.VodLocations(root_dir=small_tree["root_dir"])
    tf1, tf2 = (vod_io.FrameTransforms(loc, f) for f in ("00000", "00001"))
    t12 = flow_samples.ego_transform(tf1, tf2)
    np.testing.assert_allclose(t12[:3, 3], [0.5, 0, 0], atol=1e-5)
    np.testing.assert_array_equal(t12, jflow.ego_transform(tf1, tf2))
    pc = vod_io.VodFrame(loc, "00000").radar_data
    np.testing.assert_array_equal(flow_samples.rigid_flow_from_ego(pc, t12),
                                  jflow.rigid_flow_from_ego(pc, t12))


def test_boxes_match_jax():
    lines = [
        "Car 3 0 0 0 0 0 0 1.5 1.8 4.0 1.0 2.0 3.0 0.5 0.9\n",
        "Ped 4 0 0 0 0 0 0 0 1.7 0.6 0.6 -1.0 0.0 5.0 0.1 0.7\n",
        "short line\n",
    ]
    labels = boxes.parse_track_labels(lines)
    np.testing.assert_array_equal(labels, jboxes.parse_track_labels(lines))
    rng = np.random.RandomState(0)
    t_sc = np.eye(4)
    t_sc[:3, 3] = rng.randn(3)
    box, jbox = (m.box_from_label(labels[0], t_sc, np.eye(3))
                 for m in (boxes, jboxes))
    for k in ("center", "rotation", "extent"):
        np.testing.assert_array_equal(getattr(box, k), getattr(jbox, k))
    pts = rng.randn(200, 3) * 2 + box.center
    np.testing.assert_array_equal(box.points_inside(pts),
                                  jbox.points_inside(pts))
    t2 = box.transform().copy()
    t2[:3, 3] += [1.0, 0.5, 0.0]
    np.testing.assert_array_equal(
        boxes.inbox_flow(pts, box.transform(), t2),
        jboxes.inbox_flow(pts, jbox.transform(), t2))
    labels2 = labels.copy()
    labels2[:, 3] += 0.5
    got = boxes.extract_fg_labels(labels, labels2, pts, t_sc, np.eye(3))
    want = jboxes.extract_fg_labels(labels, labels2, pts, t_sc, np.eye(3))
    assert got[0] == want[0] and len(got[0]) > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


# --------------------------------------------------------------------------
# the sample builder, without camera flow

@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_build_sample_matches_jax(small_tree, mode):
    loc = vod_io.VodLocations(root_dir=small_tree["root_dir"])
    jloc = jvod_io.VodLocations(root_dir=small_tree["root_dir"])
    if mode == "train":
        labels = os.path.join(small_tree["pseudo_label_path"], "delft_2")
        f1, f2 = "00000", "00001"
    else:
        labels = small_tree["true_label_path"]
        f1, f2 = ("00006", "00007") if mode == "val" else ("00009", "00010")
    got = build_sample(f1, f2, loc, labels, mode)
    want = jflow.build_sample(f1, f2, jloc, labels, mode)
    assert got == want
    # the object is found: pseudo (train) or gt (val/test) confidences
    mask = np.array(got["pse_mask" if mode == "train" else "gt_mask"])
    assert ((mask > 0) & (mask < 1)).sum() >= 5 and (mask == 1).sum() > 50


def test_process_clip_matches_jax(small_tree, tmp_path):
    loc = vod_io.VodLocations(root_dir=small_tree["root_dir"])
    frames = vod_io.get_frame_list(
        os.path.join(small_tree["clips_dir"], "delft_1.txt"))
    assert frames == ["00006", "00007", "00008"]
    args = (frames, None, "delft_1", "val", small_tree["true_label_path"],
            "val")
    n = process_clip(loc, args[0], str(tmp_path / "port"), *args[2:],
                     log=quiet)
    assert n == jflow.process_clip(loc, args[0], str(tmp_path / "jax"),
                                   *args[2:], log=quiet) == 2
    port, ref = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert sorted(port) == ["val/delft_1/00006_00007.json",
                            "val/delft_1/00007_00008.json"]
    assert port == ref


@pytest.mark.parametrize("tree", ["small_tree", "vod_tree"])
def test_run_preprocess_matches_jax(request, tmp_path, tree):
    """Every split with ``ZeroFlowProvider``: JAX's JSON value for value."""
    paths = request.getfixturevalue(tree)
    splits = {k: v[:1] for k, v in SPLITS.items()} if tree == "vod_tree" \
        else SPLITS
    run_preprocess(save_dir=str(tmp_path / "port"), splits=splits,
                   opt_provider=optical_flow.ZeroFlowProvider(), log=quiet,
                   **paths)
    jflow.run_preprocess(save_dir=str(tmp_path / "jax"), splits=splits,
                         opt_provider=jopt.ZeroFlowProvider(), log=quiet,
                         **paths)
    port, ref = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert len(port) == 2 * sum(len(c) for c in splits.values())
    assert port == ref
    train = [v for k, v in port.items() if k.startswith("flow_smp/train/")]
    assert all(len(s["opt_info"]["opt_flow"]) == len(s["pc1"]) > 50
               for s in train)


# --------------------------------------------------------------------------
# RAFT-small through the provider and the CLI

def compare_raft_trees(port, ref):
    """Equal except ``opt_flow``, which is within ``FLOW_ATOL``; returns
    the largest difference."""
    assert sorted(port) == sorted(ref) and port
    worst = 0.0
    for name in ref:
        got, want = copy.deepcopy(port[name]), copy.deepcopy(ref[name])
        g_opt, w_opt = (d["opt_info"].pop("opt_flow") for d in (got, want))
        assert got == want, name
        g_opt, w_opt = np.array(g_opt), np.array(w_opt)
        assert g_opt.shape == w_opt.shape == (len(got["pc1"]), 2)
        assert np.isfinite(g_opt).all()
        worst = max(worst, float(np.abs(g_opt - w_opt).max()))
    return worst


def test_raft_provider_matches_jax(small_tree, raft_pth, tmp_path):
    splits = {"train": SPLITS["train"]}
    run_preprocess(save_dir=str(tmp_path / "port"), splits=splits, log=quiet,
                   opt_provider=optical_flow.RaftSmallProvider(
                       raft_pth, iters=3, device="cpu"), **small_tree)
    jflow.run_preprocess(save_dir=str(tmp_path / "jax"), splits=splits,
                         log=quiet, opt_provider=jopt.RaftSmallProvider(
                             raft_pth, iters=3), **small_tree)
    port, ref = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert len(port) == 4
    err = compare_raft_trees(port, ref)
    flows = np.concatenate([np.array(s["opt_info"]["opt_flow"])
                            for s in ref.values()])
    print(f"opt_flow, port against JAX: max |diff| {err:.3e} px (flow up "
          f"to {np.abs(flows).max():.2f} px)")
    assert err <= FLOW_ATOL
    assert np.abs(flows).max() > 0.1  # RAFT ran: the flow is not zero


def test_raft_provider_pads_and_crops():
    rng = np.random.RandomState(4)
    img1, img2 = (rng.randint(0, 255, (60, 75, 3)).astype(np.uint8)
                  for _ in range(2))
    provider = optical_flow.RaftSmallProvider(iters=2, device="cpu", seed=3)
    flow = provider(img1, img2)
    assert flow.shape == (60, 75, 2) and flow.dtype == np.float32
    pad = ((0, 4), (0, 5), (0, 0))
    with torch.inference_mode():
        full = provider.model(
            *(torch.from_numpy(np.pad(i, pad)).permute(2, 0, 1)[None]
              for i in (img1, img2)), iters=2)
    np.testing.assert_array_equal(
        flow, full[0].permute(1, 2, 0).numpy()[:60, :75])
    # the same seed draws the same weights
    again = optical_flow.RaftSmallProvider(iters=2, device="cpu", seed=3)
    np.testing.assert_array_equal(again(img1, img2), flow)


def test_cli_matches_run_preprocess(small_tree, raft_pth, tmp_path):
    """``python -m cmflow_tpu_torch.cli.preprocess --platform cpu``, with
    RAFT (12 iterations) and with ``--no_optical_flow``, writes what the
    port's ``run_preprocess`` writes; without ``--platform cpu`` and
    without a card it raises."""
    # the CLI runs the default splits: our clips' lists, and an empty list
    # for each of their other clips
    clips = tmp_path / "clips"
    clips.mkdir()
    for clip in sum(SCENE_FLOW_SPLITS.values(), []):
        src = os.path.join(small_tree["clips_dir"], f"{clip}.txt")
        (clips / f"{clip}.txt").write_text(
            open(src).read() if os.path.exists(src) else "")
    paths = {**small_tree, "clips_dir": str(clips)}
    common = [f"--{k}={v}" for k, v in paths.items()]
    splits = {k: [c for c in v if c in sum(SPLITS.values(), [])]
              for k, v in SCENE_FLOW_SPLITS.items()}
    assert splits == SPLITS

    assert cli.main(common + ["--save_dir", str(tmp_path / "zero"),
                              "--no_optical_flow", "--platform", "cpu"]) == 0
    jflow.run_preprocess(save_dir=str(tmp_path / "jax_zero"),
                         opt_provider=jopt.ZeroFlowProvider(), log=quiet,
                         **paths)
    assert read_tree(tmp_path / "zero") == read_tree(tmp_path / "jax_zero")

    assert cli.main(common + ["--save_dir", str(tmp_path / "cli"),
                              "--raft_weights", raft_pth,
                              "--platform", "cpu"]) == 0
    run_preprocess(save_dir=str(tmp_path / "direct"), splits=splits,
                   log=quiet, opt_provider=optical_flow.RaftSmallProvider(
                       raft_pth, device="cpu"), **paths)
    got = read_tree(tmp_path / "cli")
    assert got == read_tree(tmp_path / "direct") and len(got) == 8

    if not torch.cuda.is_available():  # RAFT runs on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(common + ["--save_dir", str(tmp_path / "nocard")])
        with pytest.raises(RuntimeError, match="CUDA"):
            optical_flow.RaftSmallProvider()
