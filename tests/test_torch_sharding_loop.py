"""gof_tpu_torch.train's data-parallel loop and CLI (`training(dp=N)`,
`python -m gof_tpu_torch.train --dp N`) against gof_tpu's and the port's
dp == 1 run, on the CPU: the ranks are processes over gloo
(parallel.sharding.launch); gof_tpu's training(dp=2) runs in this process
on two of the 8 virtual CPU devices of tests/conftest.py, its Pallas
kernels in interpret mode. The step itself is held against gof_tpu's in
tests/test_torch_sharding.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import config as jconfig
from gof_tpu import train as jtrain
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import train as ttrain

from make_synthetic_scene import make_scene

torch.set_num_threads(2)

BOUND = 1e-4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_scene(root, n_gaussians=8, n_views=4, size=32)
    return root


TRAIN_ARGS = ["--iterations", "5", "--sh_degree", "1", "--kernel_size", "0.1",
              "--densify_from_iter", "3", "--densification_interval", "4",
              "--densify_until_iter", "8", "--densify_grad_threshold", "1e-7",
              "--checkpoint_iterations", "1", "5", "--test_iterations", "5", "--quiet"]


def written(out):
    return sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                  for f in fs if not f.startswith("events.out"))


@pytest.fixture(scope="module")
def dp2_run(synth, tmp_path_factory):
    """train.main --cpu --dp 2: 5 steps, densifying at 4, checkpoints at 1
    and 5."""
    out = str(tmp_path_factory.mktemp("dp2") / "out")
    tp, gs = ttrain.main(["-s", synth, "-m", out, "--cpu", "--dp", "2", *TRAIN_ARGS])
    return out, tp, gs


def test_train_cli_dp2_writes_what_dp1_writes(synth, dp2_run, tmp_path):
    """The dp == 2 run densifies at 4 and ends with its two replicas
    bit-equal (training raises otherwise); rank 0 alone writes, once, the
    files a dp == 1 run writes, its checkpoint in dp == 1's format (which
    chip_smoke.py's parallel phase resumes in a one-rank run)."""
    out2, tp, gs = dp2_run
    out1 = str(tmp_path / "dp1")
    ttrain.main(["-s", synth, "-m", out1, "--cpu", *TRAIN_ARGS])
    assert written(out2) == written(out1)
    recs = [json.loads(line) for line in open(os.path.join(out2, "train_log.jsonl"))]
    assert [r["iter"] for r in recs] == [1, 5] and "eval" in recs[1]
    assert int(gs.active.sum()) != recs[0]["points"]  # densified
    chk = os.path.join(out2, "chkpnt5.pkl")
    tp5, st5, _, it = ttrain.load_checkpoint(chk)
    assert it == 5 and st5.count == 5 and torch.equal(tp5.gauss.xyz, tp.gauss.xyz)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_training_dp2_matches_gof_tpu_before_densification(synth, dp2_run, tmp_path):
    """The dp == 2 run's state after its first step (each rank rendering
    its own view of the same seeded draw) against gof_tpu's training(dp=2)
    on the same scene: Adam's moments within 1e-4 of max and the params
    within rtol 1e-5 (test_train_step_matches_gof_tpu's bounds), the
    visibility counts exact. Rotation is left out of the relative bound:
    init_from_points gives isotropic scales, so a rotation changes nothing
    and its gradient is rounding noise on both sides (held below 1e-7)."""
    out2 = dp2_run[0]
    jout = str(tmp_path / "gof")
    jtrain.training(
        jconfig.ModelParams(source_path=synth, model_path=jout, sh_degree=1, kernel_size=0.1),
        jconfig.OptimizationParams(iterations=1, densify_from_iter=3, densification_interval=4,
                                   densify_until_iter=8, densify_grad_threshold=1e-7),
        jconfig.PipelineParams(key_capacity=8192), set(), set(), {1}, quiet=True,
        interpret=True, dp=2)
    jtp, jst, jgs, _ = jtrain.load_checkpoint(os.path.join(jout, "chkpnt1.pkl"))
    tp, st, gs, it = ttrain.load_checkpoint(os.path.join(out2, "chkpnt1.pkl"))
    assert it == 1 and st.count == int(np.asarray(jst.count)) == 1
    active = gs.active.numpy()
    assert (active == np.asarray(jgs.active)).all()
    mu = jtrain.unflatten_gauss_t(jnp.asarray(ttrain.adam_to_numpy(st).mu_flat), jtp.gauss)
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(jst.mu_flat), jtp.gauss)
    for f in ttrain.GAUSS_FIELDS:
        got, want = np.asarray(getattr(mu, f))[active], np.asarray(getattr(jmu, f))[active]
        if f == "rotation" or not np.abs(want).any():
            assert np.abs(got).max() < 1e-7 and np.abs(want).max() < 1e-7, f
            continue
        assert rel_err(got, want) <= BOUND, (f, rel_err(got, want))
        p, jp = getattr(tp.gauss, f).numpy()[active], np.asarray(getattr(jtp.gauss, f))[active]
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5 * np.abs(jp).max(), err_msg=f)
    np.testing.assert_array_equal(gs.denom.numpy(), np.asarray(jgs.denom))
    assert gs.denom.numpy().max() > 0


def test_train_dp_refuses_without_enough_devices(synth, tmp_path, monkeypatch):
    """gof_tpu's refusal (train.py:610-613): no silent fallback to the CPU
    or to a shared card. Replaces the refusal of --dp as unported."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dp 2 needs 2 devices; only 1 visible on backend"):
        ttrain.main(["-s", synth, "-m", str(tmp_path / "x"), "--dp", "2", "--quiet"])
