"""Port serving path: ``make_eval_step`` on decoded, padded, collated
``make_scene`` batches against the JAX package's eval step (module route,
``fused="off"``) on the CPU, the port's copies of the data and metric
modules against the originals, device resolution, and the port's
independence from JAX.

Bars for the eval step are those of tests/test_torch_models.py.  The data
and metric copies must agree exactly.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.data import schema as jschema
from cmflow_tpu.data import synthetic as jsynthetic
from cmflow_tpu.data import vod as jvod
from cmflow_tpu.evaluation import metrics as jmetrics
from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.train.state import TrainState, make_optimizer
from cmflow_tpu.train.steps import make_eval_step as jax_make_eval_step
from cmflow_tpu_torch.data import schema, synthetic, vod
from cmflow_tpu_torch.evaluation import metrics
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.train.steps import make_eval_step
from cmflow_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
BARS = {"flow": 1e-4, "cls": 1e-4, "trans": 5e-4, "agree": 0.99}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    return synthetic.make_request(0, 2, (200, 256))


@pytest.fixture(scope="module")
def served(batch):
    """The JAX eval step and the port's on the same weights and batch."""
    model = jax_build_model("cmflow")
    keys = ("pc1", "pc2", "ft1", "ft2")
    args = [jnp.asarray(batch[k]) for k in keys]
    v = unfreeze(model.init({"params": jax.random.PRNGKey(0)}, *args, None,
                            True))
    _, mut = model.apply(v, *args, None, True, mutable=["batch_stats"])
    v["batch_stats"] = mut["batch_stats"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=None,
                       tx=make_optimizer())
    jbatch = {k: jnp.asarray(batch[k]) for k in keys + ("valid1", "valid2")}
    want = jax_make_eval_step("cmflow", model, fused="off")(state, jbatch)

    port = build_model("cmflow", device="cpu")
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, v))
    got = make_eval_step("cmflow", port)(batch)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


class TestEvalStep:
    def test_batch_is_padded(self, batch):
        assert batch["pc1"].shape == (2, 256, 3)
        assert not batch["valid1"].all() and batch["valid1"].any()

    def test_matches_jax_eval_step(self, batch, served):
        (sf, cls, trans, mask), (gsf, gcls, gtrans, gmask) = served
        assert gsf.shape == sf.shape and gmask.dtype == np.bool_
        np.testing.assert_allclose(gcls, cls, atol=BARS["cls"])
        np.testing.assert_allclose(gtrans, trans, atol=BARS["trans"])
        valid = batch["valid1"]
        assert (gmask == mask)[valid].mean() >= BARS["agree"]
        same = gmask == mask
        np.testing.assert_allclose(gsf[same], sf[same], atol=BARS["flow"])

    def test_metrics_match_jax_package(self, batch, served):
        _, (sf, _, trans, mask) = served
        valid = batch["valid1"]
        args = (batch["pc1"], sf, batch["labels"], batch["mask"], valid)
        got = metrics.eval_scene_flow_batch(*args)
        want = jmetrics.eval_scene_flow_batch(*args)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for fn, a in ((metrics.eval_trans_rpe_batch, (batch["trans"], trans)),
                      (metrics.eval_motion_seg_batch,
                       (mask.astype(np.float32), batch["mask"], valid))):
            got = fn(*a)
            want = getattr(jmetrics, fn.__name__)(*a)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        nv = int(valid[0].sum())
        frame = (batch["pc1"][:1, :nv], sf[:1, :nv], batch["labels"][:1, :nv],
                 batch["mask"][:1, :nv])
        assert metrics.eval_scene_flow(*frame) == jmetrics.eval_scene_flow(*frame)
        assert (metrics.eval_trans_rpe(batch["trans"], trans)
                == jmetrics.eval_trans_rpe(batch["trans"], trans))

    def test_unported_model_raises(self):
        """All three families have an eval step; an unknown name raises."""
        with pytest.raises(ValueError, match="unknown model"):
            make_eval_step("flownet", torch.nn.Linear(1, 1))


class TestDataCopies:
    def test_make_scene_and_decode(self):
        a = synthetic.make_scene(np.random.default_rng(3), n1=90, n2=110)
        b = jsynthetic.make_scene(np.random.default_rng(3), n1=90, n2=110)
        assert a == b
        for part in ("val", "train"):
            kw = dict(eval_mode=part == "val", num_points=100)
            got = vod.decode_sample(a, part, rng=np.random.default_rng(1), **kw)
            want = jvod.decode_sample(b, part, rng=np.random.default_rng(1),
                                      **kw)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_make_request(self):
        got = synthetic.make_request(5, 3, (250, 300))
        rng = np.random.default_rng(5)
        samples = []
        for _ in range(3):
            n1, n2 = (int(x) for x in rng.integers(250, 300, size=2))
            samples.append(jvod.decode_sample(
                jsynthetic.make_scene(rng, n1=n1, n2=n2), "val",
                eval_mode=True, num_points=256))
        want = jschema.collate([jschema.pad_to(s, 384) for s in samples])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_pad_bucket_collate(self):
        s = vod.decode_sample(synthetic.make_scene(np.random.default_rng(4),
                                                   n1=130, n2=300),
                              "val", eval_mode=True, num_points=256)
        for n in (1, 256, 257, 384, 385):
            assert schema.bucket_size(n) == jschema.bucket_size(n)
        got = schema.collate([schema.pad_to(s, 384)] * 2)
        want = jschema.collate([jschema.pad_to(s, 384)] * 2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        with pytest.raises(ValueError):
            schema.pad_to(s, 256)


class TestDevice:
    def test_no_gpu_and_no_device_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model("cmflow")
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        assert resolve_device("cpu").type == "cpu"


_JAX_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|flax|optax|cmflow_tpu(?!_torch))\b", re.M)


class TestIndependence:
    def test_import_loads_no_jax(self):
        code = (
            "import sys, pkgutil, importlib, cmflow_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "cmflow_tpu_torch.__path__, 'cmflow_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'cmflow_tpu')]\n"
            "print(len(names))\n"
            "print(bad)\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split("\n")
        assert int(out[0]) >= 25, out  # every module was imported
        assert out[1] == "[]", out

    def test_sources_import_no_jax(self):
        files = sorted((ROOT / "cmflow_tpu_torch").rglob("*.py"))
        files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_eval.py"]
        assert len(files) > 15
        for f in files:
            hits = _JAX_IMPORT.findall(f.read_text())
            assert not hits, (f, hits)
