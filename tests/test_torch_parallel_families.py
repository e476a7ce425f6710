"""Port parity: the data-parallel RaFlow pair step and CMFlow_T mini-clip
step of ``cmflow_tpu_torch`` (two gloo ranks on the CPU) against the JAX
package's 2-device ``shard_map`` steps and against the port in one process,
as ``tests/test_torch_parallel.py`` holds the CMFlow step (its bars; what
each rank computes is ``tests/torch_dp_ranks.py``, part ``"families"``):

* the RaFlow step and CMFlow_T's T=1 clip step against JAX's 2-device
  steps: loss items rtol 1e-4, BatchNorm statistics atol 1e-5, parameters
  after Adam atol 5e-3;
* their gradients before Adam against the port's one-process step at the
  train bars;
* CMFlow_T at T=2: two optimizer steps, finite items (JAX holds its own
  2-device T=2 step to finiteness only, tests/test_train.py:207-248);
* the variables after each step bit-identical on both ranks.
"""

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from cmflow_tpu.parallel import mesh as meshlib
from test_torch_parallel import (
    assert_same_bits,
    assert_step_matches,
    assert_train_bars,
    jax_dp_step,
    spawn_ranks,
)

STEPS = {"raflow": "raflow", "cmflow_t_t1": "cmflow_t"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("ranks"), "families")


@pytest.fixture(scope="module")
def one():
    return R.run_cases(None, "families")


@pytest.mark.parametrize("case", list(STEPS))
def test_step_against_jax_2_devices(ranks, case):
    assert_step_matches(ranks, case, jax_dp_step(
        STEPS[case], meshlib.make_mesh(num_devices=2)))


@pytest.mark.parametrize("case", list(STEPS))
def test_gradients_against_one_process(ranks, one, case):
    assert_train_bars(ranks[0][case]["grads"], one[case]["grads"])


@pytest.mark.parametrize("case", [*STEPS, "cmflow_t_t2"])
def test_ranks_hold_the_same_bits(ranks, case):
    assert_same_bits(ranks, case)


def test_clip_step_at_two_frames(ranks):
    got = ranks[0]["cmflow_t_t2"]
    assert got["step"] == 2
    assert all(np.isfinite(v) for v in got["items"].values())
