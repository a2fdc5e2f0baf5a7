"""The port's feature extractors (``gennbv_tpu_torch/models/torso.py``:
NatureCNN, MlpTorso, CnnPolicy) against the JAX package's Flax modules
with converted params (``models/convert.py``'s cnn_policy_to_state_dict),
on the same numpy images; the 36x36 guard; and tests/test_models.py's
torso case on the port."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu.models import torso as jax_torso
from gennbv_tpu_torch.models import convert
from gennbv_tpu_torch.models.torso import CnnPolicy, MlpTorso, NatureCNN

# Three convolutions (sums of 256-1024 products of images in [0, 1] and
# lecun-normal weights) and a dense layer of a few thousand terms, summed
# in another order than XLA's: ~1e-6 relative to the sums' terms, held to
# 1e-5 relative and 1e-6 absolute, as the MLP forward's
# (tests/test_torch_continuous.py).
RTOL, ATOL = 1e-5, 1e-6


def _images(n, h, w, c, seed=0):
    return np.random.default_rng(seed).random((n, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("h,w,c,net_arch", [(84, 84, 4, ()), (40, 52, 3, (32,)),
                                            (36, 36, 1, (16, 8))])
def test_cnn_policy_matches_flax(h, w, c, net_arch):
    """Non-square images check the NHWC flatten order before fc."""
    imgs = _images(3, h, w, c)
    jp = jax_torso.CnnPolicy(num_logits=6, features_dim=64, net_arch=net_arch)
    variables = jax.device_get(jp.init(jax.random.PRNGKey(1), jnp.asarray(imgs)))
    want = jax.jit(jp.apply)(variables, jnp.asarray(imgs))
    pp = CnnPolicy(h, w, c, 6, 64, net_arch, device="cpu")
    sd = convert.cnn_policy_to_state_dict(variables["params"])
    assert sorted(sd) == sorted(pp.state_dict())
    pp.load_state_dict(sd)
    with torch.no_grad():
        got = pp(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=RTOL, atol=ATOL)
    # the features alone, NatureCNN's relu(fc(.))
    jc = jax_torso.NatureCNN(features_dim=64)
    jfeat = jax.jit(jc.apply)({"params": variables["params"]["cnn"]},
                              jnp.asarray(imgs))
    with torch.no_grad():
        feat = pp.cnn(torch.from_numpy(imgs))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=RTOL,
                               atol=ATOL)


def test_mlp_torso_matches_flax():
    x = np.random.default_rng(2).normal(size=(5, 7)).astype(np.float32)
    jt = jax_torso.MlpTorso((16, 8))
    v = jax.device_get(jt.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    pt = MlpTorso(7, (16, 8), device="cpu")
    pt.load_state_dict({f"{name}.{k}": (torch.from_numpy(np.array(p["kernel"])).T
                                        if k == "weight" else
                                        torch.from_numpy(np.array(p["bias"])))
                        for name, p in v["params"].items()
                        for k in ("weight", "bias")})
    with torch.no_grad():
        got = pt(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.apply(v, x)),
                               rtol=RTOL, atol=ATOL)


def test_nature_cnn_guard():
    """SB3's constraint: images smaller than 36x36 are refused, at
    construction and at call."""
    for h, w in ((35, 84), (84, 20)):
        with pytest.raises(ValueError, match="36x36"):
            NatureCNN(h, w, 3, device="cpu")
        with pytest.raises(ValueError, match="36x36"):
            jax_torso.NatureCNN().init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, h, w, 3)))
    cnn = NatureCNN(36, 36, 3, 32, device="cpu")
    with pytest.raises(ValueError, match="36x36"):
        cnn(torch.zeros(1, 30, 36, 3))


def test_nature_cnn_and_cnn_policy():
    """tests/test_models.py's torso case on the port."""
    imgs = torch.zeros(2, 84, 84, 4)
    cnn = NatureCNN(84, 84, 4, features_dim=128, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert cnn(imgs).shape == (2, 128)
    pol = CnnPolicy(84, 84, 4, num_logits=6, features_dim=64, net_arch=(32,),
                    device="cpu", generator=torch.Generator().manual_seed(1))
    o = pol(imgs)
    assert o.logits.shape == (2, 6) and o.value.shape == (2,)
    t = MlpTorso(7, (), device="cpu")
    x = torch.ones(3, 7)
    assert torch.equal(t(x), x)
    # the heads' init: orthogonal with gains 0.01 and 1 (SB3's)
    w = pol.action_net.weight
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(6), atol=1e-7,
                               rtol=0)
