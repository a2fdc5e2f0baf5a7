"""The port's entry points (``gennbv_tpu_torch/graft_entry.py``) against the
root ``__graft_entry__.py``: the flagship policy forward from the JAX
entry's weights, and the multichip dry run on gloo CPU ranks."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import math

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from gennbv_tpu import spec
from gennbv_tpu_torch import graft_entry
from gennbv_tpu_torch.models import convert

# the full-width forward: float32 sums of up to 2,400 terms in another
# order (tests/test_torch_policy.py's tolerance)
FORWARD_TOL = 1e-5
# the dry run's data- and tensor-parallel metrics: the JAX TP test's
TP_RTOL, TP_ATOL = 2e-4, 2e-5


def test_entry_matches_the_jax_entry():
    """Shapes of the JAX entry's outputs; given its weights (carried by
    models/convert.py), the same logits and value, on its zero batch and
    on a random one."""
    jfn, (variables, zeros) = jax_entry.entry()
    fn, (policy, example) = graft_entry.entry("cpu")
    assert tuple(example.shape) == tuple(zeros.shape) == (8, spec.OBS_DIM)
    policy.load_state_dict(convert.jax_to_state_dict(variables))
    obs = np.random.default_rng(0).random((8, spec.OBS_DIM), dtype=np.float32)
    for batch in (np.array(zeros), obs):
        want = [np.asarray(x) for x in jax.jit(jfn)(variables, batch)]
        got = [x.numpy() for x in fn(policy, torch.from_numpy(batch))]
        assert [g.shape for g in got] == [w.shape for w in want] == [
            (8, spec.NUM_LOGITS), (8,)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    """One training iteration on n gloo CPU ranks, every metric finite; at
    n = 4 also env 2 x model 2, whose metrics agree with the data-parallel
    run's at the JAX TP test's tolerance."""
    runs = graft_entry.dryrun_multichip(n, "cpu")
    assert len(runs) == (2 if n == 4 else 1)
    for metrics in runs:
        assert all(math.isfinite(v) for v in metrics.values())
        assert metrics["train/n_minibatches"] > 0
    out = capsys.readouterr().out
    assert f"dryrun_multichip({n}) OK on cpu over gloo" in out
    if n == 4:
        assert "TP (env=2 x model=2) OK" in out
        dp, tp = runs
        for k in dp:
            if k.startswith(("rollout/", "train/")):
                np.testing.assert_allclose(tp[k], dp[k], rtol=TP_RTOL,
                                           atol=TP_ATOL, err_msg=k)
