"""``run_training --kernel-layout ring`` on stablelm-3b-smoke against the
reference's ``launch/train.py --kernel-layout ring`` on the same weights
(the reference runs its ring kernel interpreted on the CPU, about 25 s a
step, so these two tests sit in their own file).

Tolerances: those of test_torch_train.py / test_torch_mixing.py — losses
rtol 1e-5, parameters atol 1e-3 + rtol 1e-4 after two steps (the smoke
model's 0.02-scale embeddings under LayerNorm amplify f32 rounding ~40x a
step); static and with ``--topology-dropout 0.3``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.train import build_parser as jax_parser
from repro.launch.train import run_training as jax_run_training
from repro.models import build_model as jax_build
from repro_torch.convert import params_from_numpy
from repro_torch.core.privacy import tree_leaves
from repro_torch.launch.train import build_parser, run_training

ARCH = "stablelm-3b-smoke"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers
    (each comparison is between runs made with one thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed):
    return jax.tree.map(np.asarray,
                        jax_build(jax_config(ARCH)).init(jax.random.key(seed)))


@pytest.mark.parametrize("extra", [(), ("--topology-dropout", "0.3")],
                         ids=["static", "dropout"])
def test_run_training_ring_layout_walks_reference_trajectory(extra):
    steps, seed = 2, 3
    flags = ["--arch", ARCH, "--agents", "4", "--topology", "ring",
             "--steps", str(steps), "--log-every", "1", "--seq-len", "32",
             "--seed", str(seed), "--kernel-layout", "ring", *extra]
    want = jax_run_training(jax_parser().parse_args(flags))
    got = run_training(build_parser().parse_args(flags + ["--device", "cpu"]),
                       init_params=params_from_numpy(_jax_params(seed)))
    hist = [r for r in got["history"] if "loss" in r]
    assert [r["step"] for r in hist] == list(range(steps))
    for a, b in zip([r for r in want["history"] if "loss" in r], hist):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(want["state"].params),
                    tree_leaves(got["state"].params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3,
                                   rtol=1e-4)
