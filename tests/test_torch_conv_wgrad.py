"""The HybridEncoder's Conv3d weight gradients (``ops/conv3d_wgrad.py``) on
the CPU: the plain version against PyTorch's own, the encoder's gradients
through the autograd Function against plain ``nn.Conv3d`` autograd, the
eval forward untouched, and the kernel's launch geometry.  The kernel
itself is held on the card by tests/test_torch_card.py.  No jax here."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import ModelConfig
from gennbv_tpu_torch.models import encoder as encoder_mod
from gennbv_tpu_torch.models.encoder import HybridEncoder
from gennbv_tpu_torch.ops import _cuda, conv3d_wgrad, kernels
from gennbv_tpu_torch.utils.work import WorkCounter

# the encoder's full-width convolutions (16 channels), narrow MLPs
MODEL = ModelConfig(pose_mlp_hidden=16, grid_channels=16, fused_dim=16)


def _obs(n: int, seed: int) -> torch.Tensor:
    """Observations with the env's layout: poses, a tri-class grid, frames."""
    rng = np.random.default_rng(seed)
    pose = rng.uniform(-8, 10, (n, spec.STATE_DIM))
    grid = rng.choice([-1.0, 0.0, 1.0], (n, spec.GRID_DIM))
    rgb = rng.uniform(0, 255, (n, spec.RGB_DIM))
    return torch.from_numpy(
        np.concatenate([pose, grid, rgb], -1).astype(np.float32))


def _encoder(seed: int) -> HybridEncoder:
    torch.manual_seed(seed)
    return HybridEncoder(MODEL, device="cpu")


def _grads(enc: HybridEncoder, obs: torch.Tensor, seed: int) -> dict:
    out = enc(obs)
    weights = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    params = dict(enc.named_parameters())
    return dict(zip(params, torch.autograd.grad((out * weights).sum(),
                                                list(params.values()))))


@pytest.mark.parametrize("n", [1, 3, 16, 64])
def test_encoder_gradients_equal_plain_conv3d_autograd(monkeypatch, n):
    """Train mode, both convolutions: every parameter gradient through
    ``Conv3dWgrad`` equals, bit for bit, plain ``nn.Conv3d`` autograd's, and
    the Function ran the weight gradient once a layer."""
    enc = _encoder(n).train()
    obs = _obs(n, n)
    calls = []
    wgrad = conv3d_wgrad.conv3d_wgrad
    monkeypatch.setattr(conv3d_wgrad, "conv3d_wgrad",
                        lambda x, dy: calls.append(x.shape) or wgrad(x, dy))
    got = _grads(enc, obs, n)
    assert calls == [(n, 16, 9, 9, 9), (n, 1, 20, 20, 20)]
    monkeypatch.setattr(encoder_mod, "conv3d", lambda conv, x: conv(x))
    want = _grads(enc, obs, n)
    assert got.keys() == want.keys()
    for name in got:
        assert torch.equal(got[name], want[name]), name
    assert got["grid_conv1.weight"].abs().sum() > 0
    assert got["grid_conv2.weight"].abs().sum() > 0


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_without_gradients_is_the_module_forward(monkeypatch, mode):
    """Under no_grad (the rollout's act and the eval) the encoder's output
    equals the plain modules' bit for bit, and no Function runs."""
    enc = getattr(_encoder(7), mode)()
    obs = _obs(5, 7)
    with torch.no_grad():
        want = enc(obs)
    monkeypatch.setattr(conv3d_wgrad.Conv3dWgrad, "apply",
                        lambda *a: pytest.fail("the Function ran"))
    with torch.no_grad():
        got = enc(obs)
    monkeypatch.setattr(encoder_mod, "conv3d", lambda conv, x: conv(x))
    with torch.no_grad():
        plain = enc(obs)
    assert got.grad_fn is None
    assert torch.equal(got, want) and torch.equal(got, plain)


def test_forward_with_gradients_equals_the_module_forward(monkeypatch):
    enc = _encoder(9).train()
    obs = _obs(4, 9)
    got = enc(obs)
    monkeypatch.setattr(encoder_mod, "conv3d", lambda conv, x: conv(x))
    assert torch.equal(got, enc(obs))


@pytest.mark.parametrize("n", [1, 16, 128])
@pytest.mark.parametrize("cin, side", [(1, 20), (16, 9), (3, 11)])
def test_ref_equals_conv3d_weight_and_summed_bias(n, cin, side):
    """dW is torch.nn.grad.conv3d_weight's bit for bit; db is the sum of
    dY over samples and voxels, held to the float64 sum within 2^-20 of
    the summed magnitudes (a float32 sum in another order)."""
    gen = torch.Generator().manual_seed(n * side + cin)
    o = conv3d_wgrad.out_size(side)
    x = torch.randn(n, cin, side, side, side, generator=gen)
    dy = torch.randn(n, 16, o, o, o, generator=gen)
    dw, db = conv3d_wgrad.conv3d_wgrad(x, dy)
    assert torch.equal(dw, torch.nn.grad.conv3d_weight(
        x, (16, cin, 3, 3, 3), dy, stride=2))
    dims = (0, 2, 3, 4)
    want = dy.double().sum(dims)
    assert ((db.double() - want).abs()
            <= 2.0 ** -20 * dy.double().abs().sum(dims)).all()


def test_ref_takes_a_strided_view_of_the_observation():
    """The first layer's input is a view of the observation rows (samples
    16,792 floats apart); the result is the contiguous copy's."""
    obs = _obs(6, 1)
    x = obs[:, spec.STATE_DIM: spec.STATE_DIM + spec.GRID_DIM].reshape(
        6, 1, 20, 20, 20)
    assert not x.is_contiguous()
    dy = torch.randn(6, 16, 9, 9, 9, generator=torch.Generator().manual_seed(1))
    got = conv3d_wgrad.conv3d_wgrad(x, dy)
    want = conv3d_wgrad.conv3d_wgrad(x.contiguous(), dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("args, kwargs, error", [
    ((torch.zeros(2, 1, 20, 20, 20), torch.zeros(2, 16, 9, 9, 9)),
     {"kernel_size": 5}, ValueError),
    ((torch.zeros(2, 1, 20, 20, 20), torch.zeros(2, 16, 9, 9, 9)),
     {"stride": 1}, ValueError),
    ((torch.zeros(2, 1, 20, 20, 20, dtype=torch.float64),
      torch.zeros(2, 16, 9, 9, 9, dtype=torch.float64)), {}, TypeError),
    ((torch.zeros(2, 1, 20, 20, 20), torch.zeros(2, 16, 10, 10, 10)), {},
     ValueError),
    ((torch.zeros(2, 1, 20, 20, 20), torch.zeros(3, 16, 9, 9, 9)), {},
     ValueError),
])
def test_unsupported_inputs_raise(args, kwargs, error):
    with pytest.raises(error):
        conv3d_wgrad.conv3d_wgrad(*args, **kwargs)


@pytest.mark.parametrize("n", [1, 2, 16, 127, 128, 256, 1000])
@pytest.mark.parametrize("side", [3, 5, 9, 20, 33])
def test_geometry_covers_every_position_once(n, side):
    """For SM counts 1, 7 and 132 and several channel counts: the chunks
    are contiguous, non-empty and in order, cover the n * D'H'W' positions
    exactly once, and are as many as the kernel's grid; a tile is at most
    a chunk and fits a CTA's shared memory with the tables; the slabs
    cover the register blocks, at most MAX_BLOCKS a thread; the geometry
    is a function of its arguments."""
    o = conv3d_wgrad.out_size(side)
    positions = n * o ** 3
    for sms in (1, 7, 132):
        for cin, cout in ((1, 16), (16, 16), (2, 2), (32, 32)):
            geo = conv3d_wgrad.geometry(n, o ** 3, cin, cout, sms)
            # the kernel's chunk c: positions [c * chunk, (c + 1) * chunk)
            bounds = [(c * geo.chunk, min((c + 1) * geo.chunk, positions))
                      for c in range(geo.chunks)]
            assert len(bounds) == geo.chunks
            assert bounds[0][0] == 0 and bounds[-1][1] == positions
            assert all(lo < hi for lo, hi in bounds)
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert sum(hi - lo for lo, hi in bounds) == positions
            assert geo.chunks <= max(conv3d_wgrad.CHUNKS_PER_SM * sms,
                                     -(-positions // conv3d_wgrad.MIN_CHUNK))
            assert 1 <= geo.tile <= geo.chunk
            assert conv3d_wgrad.shared_bytes(geo.tile, cin, cout) \
                <= _cuda.SHARED_PER_CTA
            blocks = (-(-cout // 4)) * (-(-(cin * 27 + 1) // 4))
            assert geo.slabs * geo.slab_blocks >= blocks
            assert (geo.slabs - 1) * geo.slab_blocks < blocks
            assert geo.slab_blocks <= conv3d_wgrad.THREADS \
                * conv3d_wgrad.MAX_BLOCKS
            conv3d_wgrad.geometry.cache_clear()
            assert conv3d_wgrad.geometry(n, o ** 3, cin, cout, sms) == geo


def test_geometry_at_the_update_minibatch():
    """The flagship's minibatch of 128 on an H100's 132 SMs: two chunks an
    SM of the first layer's positions, each staged in one tile; the second
    layer's in chunks of MIN_CHUNK."""
    g1 = conv3d_wgrad.geometry(128, 729, 1, 16, 132)
    assert (g1.chunks, g1.chunk, g1.tile, g1.slabs) == (264, 354, 354, 1)
    g2 = conv3d_wgrad.geometry(128, 64, 16, 16, 132)
    assert (g2.chunks, g2.chunk, g2.tile, g2.slabs) == (256, 32, 32, 1)


@pytest.mark.parametrize("cin, side", [(1, 20), (16, 9)])
def test_work_is_the_hand_formula(cin, side):
    """At the update's minibatch: the first layer reads 4.1 MB of X and
    6.0 MB of dY for 80.6 MFLOP and the bias's adds."""
    o = conv3d_wgrad.out_size(side)
    x = torch.zeros(128, cin, side, side, side)
    dy = torch.zeros(128, 16, o, o, o)
    nbytes, ops = conv3d_wgrad.work(x, dy)
    positions = 128 * o ** 3
    assert nbytes == 4 * (x.numel() + dy.numel() + 16 * (27 * cin + 1))
    assert ops == 2 * positions * 16 * 27 * cin + positions * 16
    if cin == 1:
        assert (x.nbytes, dy.nbytes) == (4_096_000, 5_971_968)
        assert round(2 * positions * 16 * 27 / 1e6, 1) == 80.6


def test_launches_list_the_kernel_and_the_cpu_counts_none():
    assert "conv3d_wgrad" in kernels.WRAPPERS
    assert kernels.launches()["conv3d_wgrad"] >= 0
    before = kernels.launches()["conv3d_wgrad"]
    enc = _encoder(2).train()
    _grads(enc, _obs(3, 2), 2)
    conv3d_wgrad.conv3d_wgrad(torch.zeros(2, 1, 20, 20, 20),
                              torch.zeros(2, 16, 9, 9, 9))
    assert kernels.launches()["conv3d_wgrad"] == before


def test_work_counter_counts_the_backward_as_before(monkeypatch):
    """The bench's count of an encoder step: the same FLOPs through the
    Function as through plain autograd (the CPU takes aten's calls, which
    the counter sees)."""
    enc = _encoder(4).train()
    obs = _obs(8, 4)
    with WorkCounter() as got:
        _grads(enc, obs, 4)
    monkeypatch.setattr(encoder_mod, "conv3d", lambda conv, x: conv(x))
    with WorkCounter() as want:
        _grads(enc, obs, 4)
    assert got.flops == want.flops > 0
