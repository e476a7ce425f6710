"""The port's figures, on the CPU: ``utils/vis.py`` (BEV flow and
segmentation plots), ``preprocess/vis_frame.py`` (raw VoD frames),
``utils/plots.py`` (the training curves) and how the loop uses them.

The numpy parts are held to the JAX package's bit for bit: the colour
wheel, ``flow_xy_to_colors``, ``flow_to_image``, ``parse_frame_labels``,
``label_corners_3d`` and the image projection of the frame plots.  The PNGs
are checked as the JAX package's tests check them (tests/test_loop.py
TestVis, tests/test_preprocess.py TestFrameVisualization): written, and
more than 1000 bytes.  Without matplotlib a training run draws no curves,
logs one line saying so and trains on, while ``vis: true`` raises before
the run starts.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from cmflow_tpu.preprocess import vis_frame as jvis_frame
from cmflow_tpu.preprocess import vod_io as jvod_io
from cmflow_tpu.utils import vis as jvis
from cmflow_tpu_torch.data.synthetic import write_synthetic_dataset
from cmflow_tpu_torch.preprocess import vis_frame, vod_io
from cmflow_tpu_torch.preprocess.synthetic import write_raw_tree
from cmflow_tpu_torch.train import loop
from cmflow_tpu_torch.utils import config, plots, vis

SMALL_IMAGE = (128, 160)
SMALL_PROJECTION = [[40.0, 0.0, 80.0, 0.0], [0.0, 40.0, 64.0, 0.0],
                    [0.0, 0.0, 1.0, 0.0]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_colorwheel_and_flow_colors():
    rs = np.random.RandomState(1)
    np.testing.assert_array_equal(vis.make_colorwheel(),
                                  jvis.make_colorwheel())
    u = rs.randn(200).astype(np.float32)
    v = rs.randn(200).astype(np.float32)
    got = vis.flow_xy_to_colors(u, v)
    assert got.dtype == np.uint8 and got.shape == (200, 3)
    np.testing.assert_array_equal(got, jvis.flow_xy_to_colors(u, v))
    flow = rs.randn(12, 17, 2).astype(np.float32) * 5
    np.testing.assert_array_equal(vis.flow_to_image(flow),
                                  jvis.flow_to_image(flow))


def test_bev_plots_written(tmp_path):
    rs = np.random.RandomState(2)
    pc = rs.randn(50, 3).astype(np.float32) * 10 + [20, 0, 0]
    flow = rs.randn(50, 3).astype(np.float32)
    seg = (rs.rand(50) > 0.5).astype(np.float32)
    p1 = str(tmp_path / "flow" / "0.png")
    p2 = str(tmp_path / "seg" / "0.png")
    vis.plot_flow_bev(pc, flow, p1)
    vis.plot_seg_bev(pc, seg, p2)
    assert os.path.getsize(p1) > 1000
    assert os.path.getsize(p2) > 1000


@pytest.fixture(scope="module")
def raw_frame(tmp_path_factory):
    """A train frame of a synthetic raw tree with its image, a label in
    ``label_2`` and a lidar cloud, as the JAX package's test adds them."""
    root = str(tmp_path_factory.mktemp("raw"))
    paths = write_raw_tree(root, {"train": ["delft_1"]}, frames_per_clip=2,
                           image_size=SMALL_IMAGE,
                           projection=SMALL_PROJECTION)
    raw = paths["root_dir"]
    shutil.copy(os.path.join(paths["pseudo_label_path"], "delft_1",
                             "00000.txt"),
                os.path.join(raw, "lidar/training/label_2/00000.txt"))
    rs = np.random.RandomState(1)
    pts = np.zeros((500, 4), np.float32)
    pts[:, 0] = rs.uniform(2, 40, 500)
    pts[:, 1] = rs.uniform(-15, 15, 500)
    pts[:, 2] = rs.uniform(-1, 2, 500)
    pts.tofile(os.path.join(raw, "lidar/training/velodyne/00000.bin"))
    return raw


def frames(raw):
    loc, jloc = vod_io.VodLocations(raw), jvod_io.VodLocations(raw)
    return ((vod_io.VodFrame(loc, "00000"), vod_io.FrameTransforms(loc,
                                                                  "00000")),
            (jvod_io.VodFrame(jloc, "00000"),
             jvod_io.FrameTransforms(jloc, "00000")))


def test_labels_corners_and_projection(raw_frame):
    (fr, tf), (jfr, jtf) = frames(raw_frame)
    labels = vis_frame.parse_frame_labels(fr.raw_labels)
    assert labels == jvis_frame.parse_frame_labels(jfr.raw_labels)
    assert len(labels) == 1 and labels[0]["label_class"] == "Car"
    for target in (None, tf.t_radar_lidar):
        got = vis_frame.label_corners_3d(labels, tf.t_camera_lidar, target)
        want = jvis_frame.label_corners_3d(labels, jtf.t_camera_lidar,
                                           target)
        assert len(got) == len(want) == 1
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(a["corners_3d"], b["corners_3d"])
            assert (a["range"], a["score"]) == (b["range"], b["score"])
    for cloud, t_cs in ((fr.radar_data, tf.t_camera_radar),
                        (fr.lidar_data, tf.t_camera_lidar)):
        got = vis_frame._project_points(cloud, t_cs,
                                        tf.camera_projection_matrix,
                                        fr.image.shape, 0.0, 50.0)
        want = jvis_frame._project_points(cloud, t_cs,
                                          jtf.camera_projection_matrix,
                                          jfr.image.shape, 0.0, 50.0)
        assert len(got[0]) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_frame_plots_render(raw_frame, tmp_path):
    (fr, tf), _ = frames(raw_frame)
    p2 = vis_frame.FrameVisualizer2D(fr, tf).draw(
        str(tmp_path / "overlay.png"), show_lidar=True)
    assert os.path.getsize(p2) > 1000
    p3 = vis_frame.FrameVisualizer3D(fr, tf, origin="radar").draw(
        str(tmp_path / "scene3d.png"))
    assert os.path.getsize(p3) > 1000


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    write_synthetic_dataset(root, {"train": 4, "val": 2, "test": 2},
                            clips_per_partition=1, seed=4, n_range=(70, 90))
    return root


def tiny_cfg(tree, tmp_path, **kw):
    base = dict(exp_name="t", dataset_path=tree, epochs=2, batch_size=2,
                num_points=64, num_workers=0, eval_batch_size=2,
                checkpoints_dir=str(tmp_path / "ck"), data_parallel=False,
                eval_pad_multiple=64, platform="cpu")
    base.update(kw)
    return config.Config(**base)


def test_train_draws_the_curves_and_eval_the_frames(tree, tmp_path):
    cfg = tiny_cfg(tree, tmp_path)
    exp = loop.train_experiment(cfg)["exp_dir"]
    for png in ("loss_train/loss_train.png", "val_score.png"):
        assert os.path.getsize(os.path.join(exp, png)) > 1000, png
    ev = loop.eval_experiment(cfg.replace(
        exp_name="ev", eval=True, vis=True,
        model_path=os.path.join(exp, "models", "best")))
    assert np.isfinite(ev["sf"]["rne"])
    drawn = sorted(os.listdir(os.path.join(tmp_path, "ck", "ev", "test_vis")))
    assert drawn == ["0_flow.png", "0_seg.png", "1_flow.png", "1_seg.png"]


def test_without_matplotlib(tree, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plots.have_matplotlib()
    cfg = tiny_cfg(tree, tmp_path, exp_name="nompl")
    out = loop.train_experiment(cfg)
    assert np.isfinite(out["best_rne"])
    log = open(os.path.join(out["exp_dir"], "run.log")).read()
    assert log.count("matplotlib does not import here") == 1
    assert not os.path.exists(os.path.join(out["exp_dir"], "val_score.png"))
    for run in (loop.train_experiment, loop.eval_experiment):
        with pytest.raises(ImportError, match="vis: true"):
            run(cfg.replace(exp_name="v", vis=True, eval=run is
                            loop.eval_experiment))
