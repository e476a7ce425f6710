"""Port parity: RAFT-small of ``cmflow_tpu_torch.models.raft`` against the
JAX package's ``cmflow_tpu.models.raft`` on the CPU.

The flax parameters of ``RaftSmall().init(PRNGKey(0))`` go through
``raft_params_from_flax`` into the port's modules, which run in NCHW on the
same inputs (made with numpy from a seed).  Bars:

* the whole model: max |Δflow| <= 1e-2 px, the bar JAX's own parity test
  holds it to against torch RAFT (``tests/test_preprocess.py:352``), at
  128x160 with 6 iterations and at 64x96 with 2 (where the pyramid's last
  level is 1x1, the size that makes ``grid_sample`` divide by zero);
* each module: atol 1e-4 (rtol 1e-5 where the output grows with its input),
  float32 convolutions summed in another order;
* ``bilinear_sample`` on the grid: atol 1e-6 (``tests/test_preprocess.py:
  354-366``); the window order of ``corr_lookup``: exact, on a correlation
  volume that is not symmetric;
* a ``raft-small.pth`` the test writes (official keys, ``module.`` prefix)
  through JAX's ``load_torch_raft_small`` and the port's
  ``load_raft_small``: the same flow within 1e-2 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.models import raft as jraft
from cmflow_tpu_torch.models import raft
from cmflow_tpu_torch.models.convert import load_raft_small, raft_params_from_flax

FLOW_ATOL = 1e-2  # px
MODULE_ATOL, MODULE_RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flax_params():
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    init = jax.jit(lambda key: jraft.RaftSmall().init(
        {"params": key}, dummy, dummy, iters=1)["params"])
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_model(flax_params):
    model = raft.RaftSmall().eval()
    model.load_state_dict(raft_params_from_flax(flax_params), strict=True)
    return model


def images(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (1, h, w, 3)).astype(np.float32)
            for _ in range(2)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def jax_flow(params, img1, img2, iters):
    fwd = jax.jit(lambda p, a, b: jraft.RaftSmall().apply(
        {"params": p}, a, b, iters=iters))
    return np.asarray(fwd(params, img1, img2))


def port_flow(model, img1, img2, iters):
    with torch.inference_mode():
        return nhwc(model(nchw(img1), nchw(img2), iters=iters))


@pytest.mark.parametrize("h,w,iters", [(128, 160, 6), (64, 96, 2)])
def test_raft_matches_jax(flax_params, port_model, h, w, iters):
    img1, img2 = images(h, w)
    want = jax_flow(flax_params, img1, img2, iters)
    got = port_flow(port_model, img1, img2, iters)
    assert got.shape == want.shape == (1, h, w, 2)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"{h}x{w}, {iters} iterations: max |flow diff| {err:.3e} px "
          f"(flow up to {np.abs(want).max():.2f} px)")
    assert err <= FLOW_ATOL, err


def test_state_dict_is_torch_raft_tree(port_model):
    keys = set(port_model.state_dict())
    for key in ("fnet.conv1.weight", "fnet.layer1.0.conv1.weight",
                "fnet.layer2.0.downsample.0.weight", "cnet.conv2.bias",
                "update_block.encoder.convc1.weight",
                "update_block.gru.convz.weight",
                "update_block.flow_head.conv1.weight"):
        assert key in keys, key
    assert "fnet.layer1.0.downsample.0.weight" not in keys
    assert port_model.state_dict()["cnet.conv2.weight"].shape == (
        160, 96, 1, 1)


def _module_case(name, params, model, rng):
    """(port output, JAX output) of one module on the same inputs."""
    def rand(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    if name == "instance_norm":
        x = rand(2, 9, 11, 5, scale=3.0) + 1.0
        return (nhwc(raft.instance_norm(nchw(x))),
                np.asarray(jraft.instance_norm(x)))
    if name in ("fnet", "cnet"):
        x = rand(1, 64, 96, 3)
        enc = jraft.SmallEncoder(128, "instance") if name == "fnet" \
            else jraft.SmallEncoder(160, "none")
        want = enc.apply({"params": params[name]}, x)
        return nhwc(getattr(model, name)(nchw(x))), np.asarray(want)
    if name == "update_block":
        net, inp = np.tanh(rand(1, 8, 12, 96)), np.maximum(
            rand(1, 8, 12, 64), 0)
        corr, flow = rand(1, 8, 12, 196), rand(1, 8, 12, 2, scale=2.0)
        jnet, jdelta = jraft.SmallUpdateBlock().apply(
            {"params": params["update_block"]}, net, inp, corr, flow)
        pnet, pdelta = model.update_block(nchw(net), nchw(inp), nchw(corr),
                                          nchw(flow))
        return (np.concatenate([nhwc(pnet), nhwc(pdelta)], -1),
                np.concatenate([np.asarray(jnet), np.asarray(jdelta)], -1))
    if name == "corr_pyramid":
        f1, f2 = rand(2, 8, 12, 128), rand(2, 8, 12, 128)
        got = raft.corr_pyramid(nchw(f1), nchw(f2))
        want = jraft.corr_pyramid(f1, f2)
        assert [tuple(g.shape) for g in got] == [
            (192, 1, 8, 12), (192, 1, 4, 6), (192, 1, 2, 3), (192, 1, 1, 1)]
        return (np.concatenate([g.flatten().numpy() for g in got]),
                np.concatenate([np.asarray(v).flatten() for v in want]))
    if name == "corr_lookup":
        pyr = [rand(2 * 8 * 12, 8 >> i, 12 >> i, 1) for i in range(4)]
        # inside, on the border and outside every level
        coords = rand(2, 8, 12, 2, scale=6.0) + [6.0, 4.0]
        got = raft.corr_lookup([nchw(p) for p in pyr], nchw(coords))
        return nhwc(got), np.asarray(jraft.corr_lookup(pyr, coords))
    if name == "upflow8":
        flow = rand(2, 5, 7, 2, scale=3.0)
        return nhwc(raft.upflow8(nchw(flow))), np.asarray(
            jraft.upflow8(flow))
    if name == "bilinear_sample":
        img = rand(2, 6, 7, 3)
        coords = rand(2, 50, 2, scale=4.0) + [3.0, 2.5]
        got = raft.bilinear_sample(nchw(img), torch.from_numpy(coords))
        want = jraft.bilinear_sample(img, coords)
        return got.transpose(1, 2).numpy(), np.asarray(want)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "instance_norm", "fnet", "cnet", "update_block", "corr_pyramid",
    "corr_lookup", "upflow8", "bilinear_sample"])
def test_module_matches_jax(flax_params, port_model, name):
    with torch.inference_mode():
        got, want = _module_case(name, flax_params, port_model,
                                 np.random.RandomState(3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=MODULE_RTOL, atol=MODULE_ATOL)


def test_bilinear_sample_exact_on_grid():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 8, 9, 3).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(8), np.arange(9), indexing="ij")
    coords = np.stack([xs.flatten(), ys.flatten()], -1)[None].repeat(2, 0)
    out = raft.bilinear_sample(nchw(img),
                               torch.tensor(coords, dtype=torch.float32))
    want = img.reshape(2, -1, 3)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), want, atol=1e-6)
    # a 1x1 level: its one value at (0, 0), zero a pixel away, no NaN
    one = torch.full((1, 1, 1, 1), 2.5)
    pts = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.5, 0.0]]])
    assert raft.bilinear_sample(one, pts)[0, 0].tolist() == [2.5, 0, 0, 1.25]


def test_corr_lookup_window_order():
    """Channel ``k = i*7 + j`` takes x offset ``i - 3`` and y offset
    ``j - 3``, on a volume whose value at (x, y) is ``100*y + x`` (the
    transposed window would read ``100*x + y``)."""
    h, w = 9, 11
    vol = (100.0 * np.arange(h)[:, None] + np.arange(w)[None]).astype(
        np.float32)
    pyr_nchw = [torch.from_numpy(vol)[None, None]]
    x, y = 5.0, 4.0
    coords = torch.tensor([x, y]).reshape(1, 2, 1, 1)
    got = raft.corr_lookup(pyr_nchw, coords)[0, :, 0, 0].numpy()
    want = np.zeros(49, np.float32)
    for i in range(7):
        for j in range(7):
            xi, yj = int(x) + i - 3, int(y) + j - 3
            if 0 <= xi < w and 0 <= yj < h:
                want[i * 7 + j] = vol[yj, xi]
    np.testing.assert_array_equal(got, want)
    assert got[1] != got[7]  # not symmetric: the order is seen
    jax_got = np.asarray(jraft.corr_lookup([vol[None, :, :, None]],
                                           np.array([[[[x, y]]]],
                                                    np.float32)))
    np.testing.assert_array_equal(got, jax_got[0, 0, 0])


def test_checkpoint_loader_matches_jax(tmp_path):
    """A ``raft-small.pth`` in the public layout (torch RAFT's keys behind
    DataParallel's ``module.``), written here from seeded weights, gives
    the same flow through both loaders."""
    model = raft.RaftSmall()
    raft.init_raft_small(model, torch.Generator().manual_seed(5))
    pth = str(tmp_path / "raft-small.pth")
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               pth)

    loaded = raft.RaftSmall().eval()
    loaded.load_state_dict(load_raft_small(pth), strict=True)
    img1, img2 = images(128, 160, seed=1)
    got = port_flow(loaded, img1, img2, 4)
    want = jax_flow(jraft.load_torch_raft_small(pth), img1, img2, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"raft-small.pth through both loaders: max |flow diff| {err:.3e} "
          f"px (flow up to {np.abs(want).max():.2f} px)")
    assert err <= FLOW_ATOL, err


def test_init_raft_small_is_seeded():
    def draw(seed):
        model = raft.RaftSmall()
        raft.init_raft_small(model, torch.Generator().manual_seed(seed))
        return model.state_dict()

    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])
    # the encoders Kaiming-normal over fan_out, the update block uniform
    std = a["fnet.layer2.0.conv2.weight"].std().item()
    assert abs(std - np.sqrt(2.0 / (16 * 9))) < 0.02
    bound = 1.0 / np.sqrt((96 + 82 + 64) * 9)  # convz's fan_in
    assert a["update_block.gru.convz.weight"].abs().max().item() <= bound
