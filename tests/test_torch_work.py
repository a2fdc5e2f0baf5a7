"""The port's work counter (``gennbv_tpu_torch/utils/work.py``) on the
CPU: its FLOPs against XLA's cost analysis, its bytes, its refusal of
types other than float32 and each kernel's ``work`` entering it once;
each kernel's ``work`` against its hand formula at the eval's and the
rollout's shapes; and ``utils/device``'s line of the card."""
import subprocess

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.models.encoder import HybridEncoder
from gennbv_tpu_torch.config import ModelConfig
from gennbv_tpu_torch.ops import fused_splat, gather, scatter, zbuf_scatter
from gennbv_tpu_torch.utils import device as device_lib
from gennbv_tpu_torch.utils.work import WorkCounter, count_kernel

G = spec.GRID_SIZE


# ---- the work counter ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_counter_raises_on_a_matmul_in_another_type(dtype):
    """A matmul outside float32 would be read against the wrong peak: the
    counter refuses it."""
    x = torch.zeros(4, 4, dtype=dtype)
    with pytest.raises(ValueError, match="float32 peak"):
        with WorkCounter():
            x @ x


def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


def _conv(stride):
    return lambda x, w: jax.lax.conv_general_dilated(
        x, w, (stride,) * 3, "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


@pytest.mark.parametrize("layer", ["pose_fc1", "grid_conv1", "grid_conv2",
                                   "grid_fc"])
def test_counter_flops_equal_xla(layer):
    """One lone Linear or Conv3d of the encoder at its full width, a
    minibatch of 128 rows: the counter's FLOPs equal XLA's cost analysis
    of the same op in JAX exactly (a dot is 2mnk to both, a VALID
    convolution 2 x outputs x taps x input channels)."""
    enc = HybridEncoder(ModelConfig(), device="cpu")
    mod = getattr(enc, layer)
    b = 128
    if isinstance(mod, torch.nn.Linear):
        x = torch.zeros(b, mod.in_features)
        want = _xla_flops(lambda a, w: a @ w, jnp.zeros((b, mod.in_features)),
                          jnp.zeros((mod.in_features, mod.out_features)))
    else:
        side = G if layer == "grid_conv1" else (G - 3) // 2 + 1
        cin, cout = mod.in_channels, mod.out_channels
        x = torch.zeros(b, cin, side, side, side)
        want = _xla_flops(_conv(2), jnp.zeros((b, side, side, side, cin)),
                          jnp.zeros((3, 3, 3, cin, cout)))
    with WorkCounter() as w:
        mod(x)
    assert w.flops == want


def test_counter_bytes_are_inputs_and_outputs():
    """An op's bytes are its inputs' and outputs'; views and empty
    allocations move none."""
    x, y = torch.zeros(64, 32), torch.zeros(64, 32)
    with WorkCounter() as w:
        x.view(-1)
        x[:, :3]
        x.t()
        torch.empty(1000)
        x + y
    assert w.bytes == 3 * x.nbytes
    assert w.flops == 0.0


def _xla_unfused_bytes(fn, *args) -> float:
    """XLA's bytes accessed of `fn`'s HLO before fusion (fused, a gather
    counts its whole table: the fusion's operand)."""
    return float(jax.jit(fn).lower(*args).cost_analysis()["bytes accessed"])


def test_counter_gather_and_scatter_bytes_equal_xla():
    """Rows gathered from a large table (the update's minibatch from the
    rollout) and rows scattered into it count what XLA's cost analysis
    counts for a lone gather and scatter (twice the output and three times
    the updates, and the indices), not the whole table: within 1%, the
    share of XLA's own ops that wrap negative indices."""
    table = np.zeros((4096, 600), np.float32)
    rows = np.arange(0, 4096, 32, dtype=np.int32)
    upd = np.ones((len(rows), 600), np.float32)
    t, r = torch.from_numpy(table), torch.from_numpy(rows).long()
    with WorkCounter() as w:
        t[r]
    assert w.bytes == 2 * upd.nbytes + r.nbytes
    assert w.bytes == pytest.approx(
        _xla_unfused_bytes(lambda a, i: a[i], table, rows), rel=1e-2)
    with WorkCounter() as w:
        t.index_put_((r,), torch.from_numpy(upd))
    assert w.bytes == 3 * upd.nbytes + r.nbytes
    assert w.bytes == pytest.approx(_xla_unfused_bytes(
        lambda a, i, u: a.at[i].set(u), table, rows, upd), rel=1e-2)


def test_count_kernel_adds_work_outside_the_count():
    """A kernel's work() enters the counter once, and its own ops (the
    gather's unique) are not counted as the program's."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((2, 8, 8), dtype=np.float32))
    vi = torch.from_numpy(rng.integers(0, 8, (2, 16), dtype=np.int32))
    ui = torch.from_numpy(rng.integers(0, 8, (2, 16), dtype=np.int32))
    with WorkCounter() as w:
        count_kernel(gather.work, img, vi, ui)
    nbytes, ops = gather.work(img, vi, ui)
    assert w.bytes == nbytes
    assert w.flops == ops
    count_kernel(gather.work, img, vi, ui)     # no counter: nothing happens


# ---- each kernel's work(...) against its hand formula --------------------

def _step(n: int, q: int, hw: int, seed: int):
    """Random step inputs: pixels, depths, a validity mask (70% valid),
    voxel cells, the pooled z-buffer and the carve's G^3 pixels."""
    rng = np.random.default_rng(seed)
    pix = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(0, hw, s, dtype=np.int32))
    ok = torch.from_numpy(rng.random((n, q)) < 0.7)
    return {"vic": pix(n, q), "uic": pix(n, q),
            "z": torch.from_numpy(rng.random((n, q), dtype=np.float32)),
            "ok": ok, "veps": torch.full((n,), 0.1),
            "idx": torch.from_numpy(rng.integers(0, G, (n, q, 3),
                                                 dtype=np.int32)),
            "img": torch.from_numpy(rng.random((n, hw, hw), dtype=np.float32)),
            "cvi": pix(n, G ** 3), "cui": pix(n, G ** 3)}


@pytest.mark.parametrize("n, q, hw", [
    (spec.EVAL_NUM_ENVS, 9216, 400),     # the held-out eval at 400^2
    (256, 11264, 128),                   # the flagship rollout at 128^2
], ids=["eval", "rollout"])
@pytest.mark.parametrize("kernel", ["gather_image", "scatter_cells_any",
                                    "zbuf_visible", "zbuf_scatter_min"])
def test_work_equals_hand_formula(kernel, n, q, hw):
    """chip_smoke.py phase 3's bound formulas, written out by hand."""
    s = _step(n, q, hw, seed=q)
    nvalid = int(s["ok"].numpy().sum())
    if kernel == "gather_image":
        flat = (s["cvi"].numpy().astype(np.int64) * hw + s["cui"].numpy()
                + np.arange(n)[:, None] * hw * hw)
        m = G ** 3
        want = (4 * len(np.unique(flat)) + 12 * n * m, 2 * n * m)
        got = gather.work(s["img"], s["cvi"], s["cui"])
    elif kernel == "scatter_cells_any":
        want = (n * q + 12 * nvalid + 4 * n * G ** 3, 5 * nvalid)
        got = scatter.work(s["idx"], s["ok"], G)
    elif kernel == "zbuf_visible":
        want = (2 * n * q + 12 * nvalid + 4 * n + 4 * n * hw * hw,
                19 * nvalid + 16 * n * hw * hw)
        got = fused_splat.work(s["vic"], s["uic"], s["z"], s["ok"],
                               s["veps"], hw, hw)
    else:
        flat = s["vic"] * hw + s["uic"]
        want = (8 * n * q + 4 * n * hw * hw, 2 * n * q + n * hw * hw)
        got = zbuf_scatter.work(flat, s["z"], hw, hw)
    assert got == want


def test_card_line_is_the_first_cards_line(monkeypatch):
    """On a machine of several cards ``nvidia-smi`` prints a line each:
    ``card_line`` keeps the first, stripped."""
    def run(cmd, **kwargs):
        assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"
                           "NVIDIA H100 80GB HBM3, 500.00 W\n")
    monkeypatch.setattr(device_lib.subprocess, "run", run)
    assert device_lib.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
