"""Tests of the port that need a CUDA card: each kernel against its plain
version (the Conv3d weight gradient, which sums in its own order, against
float64, in a CUDA graph too), the mapping golden, a rollout and an eval with the kernels in
use, the exact z-buffer env against the CPU, a PPO update against the same update on the CPU, the train CLI, and
two trainings from one seed; the drone, the legged robots (plane and
rough terrain) and the recurrent actor-critic against the CPU, and two
recurrent trainings from one seed; SAC, TD3 and DQN updates and a HER
relabeled sample against the CPU, and two DQN trainings from one seed.
They skip on a machine without one.  This file imports no jax, so it
also runs where jax is missing; tests/conftest.py imports jax, so there run
it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import numpy as np
import pytest
import torch

from gennbv_tpu_torch.ops import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.parametrize("q", [11264, 8000])
def test_gather_kernel_equals_plain_at_rollout_shapes(cuda, q):
    """[256, 128, 128] images with planted values (bf16 ties, -0.0, a
    negative, empty pixels), at the surface capacity and the G^3 carve."""
    import chip_smoke
    assert chip_smoke.planted_gather_case(q)["max_abs_err"] == 0.0


@pytest.mark.parametrize("hw", [400, 128])
@pytest.mark.parametrize("q,offset", [(1, 0), (3, 0), (4, 0), (8001, 0),
                                      (8000, 1), (11264, 1), (11264, 0)])
def test_gather_kernel_edge_cases(cuda, hw, q, offset):
    """At the eval's [50, 400, 400] and the rollout's [256, 128, 128]
    images: tiny and ragged q, and index arrays that are contiguous views
    off 16-byte alignment (the scalar path), bit-equal to the plain
    version with one launch a call."""
    import chip_smoke
    n = 50 if hw == 400 else 256
    path = chip_smoke.gather_edge_case(n, hw, q, offset)
    assert path == ("scalar" if q % 4 or offset else "vector")


@pytest.mark.parametrize("g,q", [(4, 40), (20, 700), (20, 5000)])
def test_scatter_kernel_equals_plain(cuda, g, q):
    from gennbv_tpu_torch.ops import scatter
    gen = torch.Generator(device="cuda").manual_seed(g + q)
    idx = torch.randint(0, g, (3, q, 3), device="cuda", dtype=torch.int32,
                        generator=gen)
    valid = torch.rand(3, q, device="cuda", generator=gen) < 0.5
    valid[2] = False                              # an env with no valid point
    before = kernels.launches()["scatter_cells_any"]
    got = scatter.scatter_cells_any(idx, valid, g)
    torch.cuda.synchronize()
    assert kernels.launches()["scatter_cells_any"] == before + 1
    assert torch.equal(got, scatter.scatter_cells_any_ref(idx, valid, g))
    assert got[2].sum() == 0 and got[0].sum() > 0


@pytest.mark.parametrize("g,q", [(20, 11264), (20, 9216), (4, 5000), (5, 700),
                                 (20, 0), (40, 20000), (61, 5000)])
def test_scatter_kernel_all_valid_and_one_cell(cuda, g, q):
    """Every point valid (env 0), every point in one cell (env 1), a cell
    per point cycling through the whole grid (env 2), no point at all
    (q = 0); the grid is not zeroed before the kernel, so every cell it
    leaves empty must be written as 0.  G = 5 has a grid whose env rows are
    not 16-byte aligned; G = 40 and 61 take more than 48 KB of shared
    memory, G = 61 nearly all a CTA may have."""
    from gennbv_tpu_torch.ops import scatter
    gen = torch.Generator(device="cuda").manual_seed(g + q)
    idx = torch.randint(0, g, (3, q, 3), device="cuda", dtype=torch.int32,
                        generator=gen)
    valid = torch.ones(3, q, dtype=torch.bool, device="cuda")
    idx[1] = torch.tensor([g - 1, 0, g // 2], dtype=torch.int32)
    cell = torch.arange(q, device="cuda") % g ** 3
    idx[2] = torch.stack([cell // g ** 2, cell // g % g, cell % g], -1).int()
    # garbage where the grid will be allocated, so an unwritten cell shows
    torch.full((3, g, g, g), 7.0, device="cuda")
    before = kernels.launches()["scatter_cells_any"]
    got = scatter.scatter_cells_any(idx, valid, g)
    torch.cuda.synchronize()
    assert kernels.launches()["scatter_cells_any"] == before + 1
    assert torch.equal(got, scatter.scatter_cells_any_ref(idx, valid, g))
    assert got[1].sum() == (q > 0)
    assert got[2].sum() == min(q, g ** 3)


def test_scatter_kernel_refuses_a_grid_no_cta_holds(cuda):
    from gennbv_tpu_torch.ops import scatter
    idx = torch.zeros(2, 10, 3, dtype=torch.int32, device="cuda")
    valid = torch.ones(2, 10, dtype=torch.bool, device="cuda")
    before = kernels.launches()["scatter_cells_any"]
    with pytest.raises(ValueError):
        scatter.scatter_cells_any(idx, valid, 62)
    assert kernels.launches()["scatter_cells_any"] == before


def test_span_brackets_its_kernel_on_the_profilers_clock(cuda):
    """A span around one ``zbuf_visible`` call and a synchronize, under a
    device-only profile as the benchmark takes it, lies around the
    kernel's device record: device records and spans share one clock."""
    import time

    from torch.autograd import DeviceType

    from gennbv_tpu_torch.ops import fused_splat
    from gennbv_tpu_torch.utils import profiling
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, q, h, w = 50, 9216, 400, 400
    vic = torch.randint(0, h, (n, q), device="cuda", dtype=torch.int32,
                        generator=gen)
    uic = torch.randint(0, w, (n, q), device="cuda", dtype=torch.int32,
                        generator=gen)
    z = torch.rand(n, q, device="cuda", generator=gen) * 28.0 + 1.0
    ok = torch.rand(n, q, device="cuda", generator=gen) < 0.7
    veps = torch.full((n,), 0.15, device="cuda")
    fused_splat.zbuf_visible(vic, uic, z, ok, veps, h, w, 50.0)  # the build
    torch.cuda.synchronize()

    def pads():
        # a session loses device records at its ends (benchmark/trace.py)
        for _ in range(64):
            torch.cuda._sleep(50_000)
        torch.cuda.synchronize()

    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pads()
        with profiling.span("card/zbuf", unit="card"):
            fused_splat.zbuf_visible(vic, uic, z, ok, veps, h, w, 50.0)
            torch.cuda.synchronize()
        pads()
    (mine,) = [s for s in profiling.spans()
               if s.name == "card/zbuf" and s.start_ns >= t0]
    found = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not e.is_user_annotation() and "zbuf_visible" in e.name()]
    assert len(found) == 1, [e.name() for e in found]
    kernel = found[0]
    assert mine.start_ns <= kernel.start_ns() < kernel.end_ns() \
        <= mine.end_ns, (kernel.start_ns() - mine.start_ns,
                         mine.end_ns - kernel.end_ns())


@pytest.mark.parametrize("h,w,q,footprint", [(16, 16, 40, 1), (64, 48, 700, 1),
                                              (40, 40, 3000, 0), (37, 53, 5000, 2)])
def test_fused_splat_kernel_equals_plain(cuda, h, w, q, footprint):
    """Random pixels and depths; env 0 has no valid point, env 1 piles
    thousands of points on a few pixels in a narrow depth band."""
    from gennbv_tpu_torch.ops import fused_splat
    gen = torch.Generator(device="cuda").manual_seed(h + q)
    n = 4
    vic = torch.randint(0, h, (n, q), device="cuda", dtype=torch.int32, generator=gen)
    uic = torch.randint(0, w, (n, q), device="cuda", dtype=torch.int32, generator=gen)
    z = torch.rand(n, q, device="cuda", generator=gen) * 28.0 + 1.0
    ok = torch.rand(n, q, device="cuda", generator=gen) < 0.7
    ok[0] = False
    vic[1] %= 3
    uic[1] %= 2
    z[1] = 4.0 + z[1] / 140.0
    veps = torch.tensor([0.15, 0.2, 0.1, 0.17], device="cuda")
    before = kernels.launches()["zbuf_visible"]
    got = fused_splat.zbuf_visible(vic, uic, z, ok, veps, h, w, 50.0, footprint)
    torch.cuda.synchronize()
    assert kernels.launches()["zbuf_visible"] == before + 1
    want = fused_splat.zbuf_visible_ref(vic, uic, z, ok, veps, h, w, 50.0,
                                        footprint)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][0] == 50.0).all() and not got[1][0].any()
    assert got[1][2:].any()


def _band_edge_inputs(n, q, h, w, ctas, seed):
    """Random points; env 0's rows are the first and last row of every band
    of `ctas` CTAs, env 1 piles 4096 points on one pixel of a band edge (at
    many depths) beside random ones, env 2 has no valid point."""
    from gennbv_tpu_torch.ops import fused_splat
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vic = torch.randint(0, h, (n, q), device="cuda", dtype=torch.int32, generator=gen)
    uic = torch.randint(0, w, (n, q), device="cuda", dtype=torch.int32, generator=gen)
    z = torch.rand(n, q, device="cuda", generator=gen) * 28.0 + 1.0
    ok = torch.rand(n, q, device="cuda", generator=gen) < 0.7
    band = fused_splat.band_rows(h, ctas)
    edges = sorted({r for b in range(ctas) for r in (b * band, (b + 1) * band - 1)
                    if r < h} | {h - 1})
    rows = torch.tensor(edges, dtype=torch.int32, device="cuda")
    vic[0] = rows[torch.arange(q, device="cuda") % len(edges)]
    pile = min(4096, q)
    vic[1, :pile] = edges[len(edges) // 2]
    uic[1, :pile] = w // 2
    ok[1, :pile] = True
    ok[2] = False
    veps = torch.full((n,), 0.15, device="cuda")
    return vic, uic, z, ok, veps


@pytest.mark.parametrize("h,w,footprint,ctas", [
    (401, 300, 1, None), (401, 300, 2, None), (400, 400, 1, None),
    (128, 128, 1, 2), (37, 53, 2, 3), (37, 53, 2, 8), (16, 16, 1, 8),
    (33, 40, 1, 8), (40, 40, 0, 5), (64, 48, 1, 1)])
def test_fused_splat_kernel_band_edges(cuda, h, w, footprint, ctas):
    """Points on the first and last row of every CTA's band, a pile-up of
    4096 points on one pixel, an env with no valid point; enough points
    that a CTA also reads points it does not keep in registers.  `ctas`
    forces the cluster size (None: the wrapper's choice; 401 rows are not
    a multiple of it, and 33 rows over 8 CTAs leave the last band empty)."""
    from gennbv_tpu_torch.ops import fused_splat
    n, q = 3, 40000
    c = fused_splat.cluster_ctas(h, w, footprint) if ctas is None else ctas
    inputs = _band_edge_inputs(n, q, h, w, c, h + w + footprint)
    before = kernels.launches()["zbuf_visible"]
    got = (fused_splat.zbuf_visible(*inputs, h, w, 50.0, footprint)
           if ctas is None else
           fused_splat.launch(*inputs, h, w, 50.0, footprint, ctas))
    torch.cuda.synchronize()
    assert kernels.launches()["zbuf_visible"] == before + 1
    want = fused_splat.zbuf_visible_ref(*inputs, h, w, 50.0, footprint)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][2] == 50.0).all() and not got[1][2].any()
    assert got[1][0].any() and got[1][1].any()


@pytest.mark.parametrize("n,q", [(2, 0), (0, 700)])
def test_fused_splat_kernel_without_points_or_envs(cuda, n, q):
    """q = 0: a z-buffer of depth_max everywhere; n = 0: empty outputs and
    no launch."""
    from gennbv_tpu_torch.ops import fused_splat
    vic = torch.zeros(n, q, dtype=torch.int32, device="cuda")
    z = torch.ones(n, q, device="cuda")
    ok = torch.ones(n, q, dtype=torch.bool, device="cuda")
    veps = torch.full((n,), 0.1, device="cuda")
    before = kernels.launches()["zbuf_visible"]
    zbuf, vis = fused_splat.zbuf_visible(vic, vic, z, ok, veps, 400, 400, 50.0)
    torch.cuda.synchronize()
    assert kernels.launches()["zbuf_visible"] == before + (n > 0)
    assert zbuf.shape == (n, 400 * 400) and vis.shape == (n, q)
    assert (zbuf == 50.0).all()


@pytest.mark.parametrize("h,w,q", [(400, 400, 9216), (128, 128, 11264),
                                   (401, 300, 5000), (37, 53, 700),
                                   (16, 16, 40), (90, 20000, 3000)])
def test_zbuf_scatter_kernel_equals_plain(cuda, h, w, q):
    """Points on the first and last row of every band (env 0), a
    pile-up of points on one pixel at many depths (env 1), no valid point
    (env 2), negative depths with pixels that get only -0.0 or only +0.0
    (env 3); 401 rows leave a short last band, a 20,000-pixel row takes
    one band a row, 37x53 images start off 16-byte boundaries."""
    from gennbv_tpu_torch.ops import zbuf_scatter
    gen = torch.Generator(device="cuda").manual_seed(h + w + q)
    n = 4
    flat = torch.randint(0, h * w, (n, q), device="cuda", dtype=torch.int32,
                         generator=gen)
    zz = torch.rand(n, q, device="cuda", generator=gen) * 29.0 + 1.0
    zz[torch.rand(n, q, device="cuda", generator=gen) < 0.3] = 50.0
    rows = zbuf_scatter.geometry(n, q, h, w, zbuf_scatter.sm_count(0)).rows
    edges = torch.tensor(sorted({r for b in range(0, h, rows)
                                 for r in (b, min(h, b + rows) - 1)}),
                         dtype=torch.int32, device="cuda")
    flat[0] = edges[torch.arange(q, device="cuda") % len(edges)] * w \
        + flat[0] % w
    flat[1, : q // 2] = (h // 2) * w + w // 2
    zz[2] = 50.0
    zz[3] = zz[3] * 2.0 - 31.0
    flat[3, :2] = torch.tensor([3, 4], dtype=torch.int32)
    zz[3][flat[3] == 3] = -0.0
    zz[3][flat[3] == 4] = 0.0
    before = kernels.launches()["zbuf_scatter_min"]
    got = zbuf_scatter.zbuf_scatter_min(flat, zz, h, w, 50.0)
    torch.cuda.synchronize()
    assert kernels.launches()["zbuf_scatter_min"] == before + 1
    want = zbuf_scatter.zbuf_scatter_min_ref(flat, zz, h, w, 50.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[2] == 50.0).all() and (got[1] < 50.0).sum() <= q - q // 2 + 1
    assert got[3].min() < 0 and torch.signbit(got[3].reshape(-1)[3])


@pytest.mark.parametrize("n,q", [(2, 0), (0, 700), (1, 1)])
def test_zbuf_scatter_kernel_without_points_or_envs(cuda, n, q):
    """q = 0: the fill everywhere (the kernel writes every pixel of an
    image it was not given filled); n = 0: an empty output and no launch;
    q = 1: one pixel below the fill."""
    from gennbv_tpu_torch.ops import zbuf_scatter
    torch.full((max(n, 1), 400, 400), 7.0, device="cuda")   # garbage to reuse
    flat = torch.full((n, q), 400 * 200 + 17, dtype=torch.int32, device="cuda")
    zz = torch.full((n, q), 3.5, device="cuda")
    before = kernels.launches()["zbuf_scatter_min"]
    got = zbuf_scatter.zbuf_scatter_min(flat, zz, 400, 400, 50.0)
    torch.cuda.synchronize()
    assert kernels.launches()["zbuf_scatter_min"] == before + (n > 0)
    assert got.shape == (n, 400, 400)
    assert torch.equal(got, zbuf_scatter.zbuf_scatter_min_ref(flat, zz, 400,
                                                              400, 50.0))
    assert (got < 50.0).sum() == n * min(q, 1)


def test_zbuf_scatter_kernel_at_the_tools_defaults(cuda):
    """tools/bench_scatter.py's inputs (256 x 11264 at 128x128), and
    bit-equal with one device launch a call at chip_smoke.py's edge cases:
    Q of 1, 0 and ragged, env counts that do not divide over the card's
    CTAs, odd widths and env offsets off 16-byte boundaries, and pile-ups
    on either side of a band edge."""
    import chip_smoke
    assert chip_smoke.zbuf_scatter_case(
        "tool", *chip_smoke.tool_zbuf_inputs(), 128, 128, 50.0)[
            "max_abs_err"] == 0.0
    for case in chip_smoke.ZBUF_EDGES:
        chip_smoke.zbuf_scatter_edge_case(*case)


@pytest.mark.parametrize("n", [1, 16, 127, 128, 256])
@pytest.mark.parametrize("layer", [1, 2])
def test_conv3d_wgrad_kernel_against_float64(cuda, n, layer):
    """The encoder's two layers at minibatches of 1 to 256 (the first's X a
    strided view of observations): dW and db within chip_smoke's
    WGRAD_REL_TOL of the sum of the products' magnitudes from the float64
    gradient (each output a chain of fewer than 2^10 float32 additions),
    the same bits from two calls, and one count a call."""
    import chip_smoke
    x, dy = chip_smoke.wgrad_inputs(n, n)[layer - 1]
    before = kernels.launches()["conv3d_wgrad"]
    assert chip_smoke.wgrad_held(f"layer {layer}, n {n}", x, dy) \
        <= chip_smoke.WGRAD_REL_TOL
    torch.cuda.synchronize()
    assert kernels.launches()["conv3d_wgrad"] == before + 2


def test_conv3d_wgrad_kernel_more_channels_than_a_slab(cuda):
    """40 -> 24 channels on 7^3: the register blocks take several slabs,
    a CTA each; an odd channel count pads its last block."""
    import chip_smoke
    from gennbv_tpu_torch.ops import conv3d_wgrad
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(9, 40, 7, 7, 7, device="cuda", generator=gen)
    dy = torch.randn(9, 23, 3, 3, 3, device="cuda", generator=gen)
    assert conv3d_wgrad.geometry(9, 27, 40, 23, torch.cuda.get_device_properties(
        0).multi_processor_count).slabs > 1
    chip_smoke.wgrad_held("slabs", x, dy)


def test_conv3d_wgrad_kernel_replays_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph (workspace and outputs from the graph's
    pool, launches on the capture stream), a replay on new inputs in the
    same buffers gives the eager call's bits."""
    from gennbv_tpu_torch.ops import conv3d_wgrad
    import chip_smoke
    (x, dy), _ = chip_smoke.wgrad_inputs(128, 3)
    conv3d_wgrad.conv3d_wgrad(x, dy)                  # build, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dw, db = conv3d_wgrad.conv3d_wgrad(x, dy)
    (x2, dy2), _ = chip_smoke.wgrad_inputs(128, 4)
    x.copy_(x2)
    dy.copy_(dy2)
    graph.replay()
    want = conv3d_wgrad.conv3d_wgrad(x, dy)
    torch.cuda.synchronize()
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])


@pytest.mark.parametrize("x_shape, dy_shape, kwargs, error", [
    ((2, 1, 20, 20, 20), (2, 16, 9, 9, 9), {"kernel_size": 5}, ValueError),
    ((2, 1, 20, 20, 20), (2, 16, 9, 9, 9), {"stride": 1}, ValueError),
    ((2, 1, 20, 20, 20), (2, 16, 18, 18, 18), {}, ValueError),
])
def test_conv3d_wgrad_kernel_refuses_what_it_does_not_take(
        cuda, x_shape, dy_shape, kwargs, error):
    from gennbv_tpu_torch.ops import conv3d_wgrad
    before = kernels.launches()["conv3d_wgrad"]
    with pytest.raises(error):
        conv3d_wgrad.conv3d_wgrad(torch.zeros(x_shape, device="cuda"),
                                  torch.zeros(dy_shape, device="cuda"),
                                  **kwargs)
    with pytest.raises(TypeError):
        conv3d_wgrad.conv3d_wgrad(
            torch.zeros(2, 1, 20, 20, 20, device="cuda", dtype=torch.half),
            torch.zeros(2, 16, 9, 9, 9, device="cuda", dtype=torch.half))
    assert kernels.launches()["conv3d_wgrad"] == before


def test_golden_on_card(cuda):
    import chip_smoke
    chip_smoke.phase_golden()


def test_rollout_launches_the_kernel_twice_per_step(cuda):
    """Each of the splat path's three kernels once per env step: the fused
    splat, the hit scatter and the carve gather; the exact scatter-min
    never."""
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.algo import rollout
    from gennbv_tpu_torch.env import ReconEnv, make_scenes
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy
    import chip_smoke

    cfg = config.EnvConfig(num_envs=8, camera=config.CameraConfig(height=32, width=32),
                           renderer=config.RendererConfig(resolution=16),
                           scene=config.SceneConfig(num_scenes=4, seed=1))
    env = ReconEnv(cfg, make_scenes(cfg.scene, 16))
    gen = torch.Generator(device="cuda").manual_seed(0)
    policy = ActorCriticPolicy(config.ModelConfig(), gen)
    chip_smoke.reset_launches()
    state, out = env.reset(8)
    _, obs, batch, stats = rollout.collect(env, policy, state, out.obs, gen, 4, 0.99)
    torch.cuda.synchronize()
    assert chip_smoke.launches() == chip_smoke.splat_expect(1 + 4)
    assert obs.is_cuda and torch.isfinite(batch.values).all()
    assert ((stats.coverage >= 0) & (stats.coverage <= 1)).all()


def test_eval_launches_each_kernel_per_step(cuda):
    """A small held-out eval on the batched splat path: each kernel runs
    once for the init-view cache, once for the reset and once per step;
    without the cache (zbuf_impl=mxu) the same kernels run once per step
    and give the same results."""
    import chip_smoke
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.env import make_scenes
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy

    def small(zbuf_impl):
        cfg = chip_smoke.eval_config(zbuf_impl)
        return dataclasses.replace(
            cfg, num_envs=4, max_episode_length=6,
            camera=config.CameraConfig(height=48, width=48),
            renderer=dataclasses.replace(cfg.renderer, resolution=24),
            scene=config.SceneConfig(num_scenes=4, seed=100))

    cfg = small("pallas")
    scenes = make_scenes(cfg.scene, 24)
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    res, counts, _ = chip_smoke.run_eval(cfg, scenes, policy)
    assert counts == chip_smoke.splat_expect(2 + 6)
    chip_smoke.check_eval(res, 6)
    mxu, counts, _ = chip_smoke.run_eval(small("mxu"), scenes, policy)
    assert counts == chip_smoke.splat_expect(1 + 6)
    np.testing.assert_array_equal(res.per_env_coverage, mxu.per_env_coverage)
    np.testing.assert_array_equal(res.per_env_auc, mxu.per_env_auc)


NARROW = dict(pose_mlp_hidden=32, grid_channels=4, fused_dim=32)


def _kl_stop_target(ppo, run) -> tuple[float, int]:
    """A target_kl that stops an update mid-run with a margin: `run`
    (cfg) runs the update without a stop on the CPU while its minibatch
    KLs are recorded; the stop goes at the first minibatch j whose KL is
    at least 1.44 times every earlier one's, the threshold (1.5 x
    target_kl) at the geometric mean of the two, 20% from each.  Returns
    (target_kl, j)."""
    kls, real = [], ppo._loss

    def recording(*args):
        loss, metrics = real(*args)
        kls.append(float(metrics[3]))
        return loss, metrics

    ppo._loss = recording
    try:
        run()
    finally:
        ppo._loss = real
    j = next(j for j in range(1, len(kls) - 1)
             if kls[j] >= 1.44 * max(kls[:j]))
    return (max(kls[:j]) * kls[j]) ** 0.5 / 1.5, j


@pytest.mark.parametrize("stop", [False, True], ids=["all", "kl_stop"])
def test_update_on_card_matches_cpu(cuda, stop):
    """One PPO update (8 minibatches of 32 rows over 4 shards, 2 epochs) at
    a narrow width, on the card and on the CPU from the same weights, data
    and minibatches, once with every minibatch applied and once with the
    KL stop mid-run (both stop at the same minibatch; the card's gated
    step replays the captured graph and skips the rest).  cuDNN and
    cuBLAS (full float32, TF32 off) sum in another order than the CPU:
    the tolerances of tests/test_torch_ppo.py, whose conv biases ahead of
    a BatchNorm, and the running means that take them in, move by
    rounding noise only (their gradient is 0 in exact arithmetic)."""
    from gennbv_tpu_torch import config, spec
    from gennbv_tpu_torch.algo import ppo
    from gennbv_tpu_torch.models import distributions
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy

    cpu = ActorCriticPolicy(config.ModelConfig(**NARROW),
                            torch.Generator().manual_seed(0), device="cpu")
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = ActorCriticPolicy(config.ModelConfig(**NARROW), device="cuda")
    card.load_state_dict(start)
    m, n_envs = 128, 8
    rng = np.random.default_rng(0)
    obs = np.concatenate([rng.uniform(-8, 10, (m, spec.STATE_DIM)),
                          rng.choice([-1.0, 0.0, 1.0], (m, spec.GRID_DIM)),
                          rng.uniform(0, 255, (m, spec.RGB_DIM))], -1)
    obs = torch.from_numpy(obs.astype(np.float32))
    actions = torch.from_numpy(np.stack(
        [rng.integers(0, k, m) for k in spec.NVEC], -1).astype(np.int32))
    with torch.no_grad():
        out = cpu.eval()(obs)
    logp = distributions.log_prob(out.logits, actions)
    adv = torch.from_numpy(rng.normal(0, 1, m).astype(np.float32))
    data = (obs, actions, logp, out.value, adv, adv + out.value)
    cfg = config.PPOConfig(n_steps=16, batch_size=32, n_epochs=2,
                           learning_rate=3e-3 if stop else 3e-4,
                           minibatch_shards=4, target_kl=None)
    idx = ppo.minibatch_indices(cfg, m, n_envs, torch.Generator().manual_seed(1))

    def run(policy, dev, cfg):
        opt = ppo.make_optimizer(cfg, n_envs)
        return ppo.update(policy, opt, cfg, opt.init(policy),
                          *(x.to(dev) for x in data), num_envs=n_envs,
                          indices=idx.to(dev))

    n_done = 8
    if stop:
        scratch = ActorCriticPolicy(config.ModelConfig(**NARROW), device="cpu")
        scratch.load_state_dict(start)
        target, n_done = _kl_stop_target(ppo, lambda: run(scratch, "cpu", cfg))
        cfg = dataclasses.replace(cfg, target_kl=target)
    results = []
    for policy, dev in ((cpu, "cpu"), (card, "cuda")):
        state, metrics = run(policy, dev, cfg)
        results.append((policy.state_dict(), state, metrics))
    (sd_c, st_c, m_c), (sd_g, st_g, m_g) = results
    noise = ("encoder.grid_conv1.bias", "encoder.grid_conv2.bias",
             "encoder.grid_bn1.running_mean", "encoder.grid_bn2.running_mean")
    for k, v in sd_c.items():
        assert sd_g[k].is_cuda
        np.testing.assert_allclose(sd_g[k].cpu().numpy(), v.numpy(), rtol=0,
                                   atol=3e-5 if k in noise else 2e-6, err_msg=k)
    assert int(st_c.count) == int(st_g.count) == n_done
    for k in st_c.mu:
        if k in noise:
            continue
        np.testing.assert_allclose(st_g.mu[k].cpu().numpy(), st_c.mu[k].numpy(),
                                   rtol=1e-4, atol=5e-8, err_msg=k)
        np.testing.assert_allclose(st_g.nu[k].cpu().numpy(), st_c.nu[k].numpy(),
                                   rtol=1e-4, atol=1e-11, err_msg=k)
    assert float(m_g.n_minibatches_done) == float(m_c.n_minibatches_done) \
        == n_done
    # the explained variance is 1 minus a ratio of float32 variances near 1
    np.testing.assert_allclose([float(x) for x in m_g],
                               [float(x) for x in m_c], rtol=1e-5, atol=1e-6)


def test_gated_adam_on_card_equals_host_adam(cuda):
    """The update's device-side Adam step (ppo.Optimizer.gated_apply_:
    count, learning rate and bias corrections read on the device, the
    clip and the KL gate as selects) against the host-side one
    (apply_, with host floats, the port's step before the update ran on
    the device), on the card: bit for bit where a step is kept, nothing
    moved where it is not, with the clip engaged and not; and a division
    by a device scalar (ppo._divided) equals PyTorch's division by the
    host float at 10,000 random scalars."""
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.algo import ppo

    gen = torch.Generator("cuda").manual_seed(0)
    xs = [torch.randn(4099, device="cuda", generator=gen) * 10]
    for s in torch.rand(10_000, device="cuda", generator=gen).exp().unbind():
        assert torch.equal(ppo._divided(xs, s)[0], xs[0] / float(s)), float(s)
    rng = np.random.default_rng(4)
    for max_norm in (10.0, 0.3):
        cfg = config.PPOConfig(learning_rate=1e-2, lr_schedule="linear",
                               n_epochs=1, n_steps=4, batch_size=8,
                               total_iters=5, max_grad_norm=max_norm)
        opt = ppo.make_optimizer(cfg, 8)
        tables = ppo.schedule_tables(opt, "cuda")
        p0 = [rng.normal(size=(300, 257)).astype(np.float32),
              rng.normal(size=7).astype(np.float32)]
        host = [[torch.from_numpy(x.copy()).cuda() for x in p0]] + [
            [torch.zeros(x.shape, device="cuda") for x in p0] for _ in range(2)]
        dev = [[t.clone() for t in ts] for ts in host]
        count, dev_count = 0, torch.zeros((), dtype=torch.int64, device="cuda")
        for k in range(30):
            g = [torch.from_numpy(rng.normal(0, 0.2, x.shape).astype(np.float32))
                 .cuda() for x in p0]
            keep = k % 3 != 1
            before = [[t.clone() for t in ts] for ts in dev]
            norm = ppo.global_norm(g)
            opt.gated_apply_(dev[0], [x.clone() for x in g], dev[1], dev[2],
                             dev_count, norm, tables,
                             torch.tensor(keep, device="cuda"))
            if keep:
                count = opt.apply_(host[0], g, host[1], host[2], count,
                                   float(norm))
            assert int(dev_count) == count
            for a, b in zip(dev, host if keep else before):
                for x, y in zip(a, b):
                    assert torch.equal(x, y), (max_norm, k)


def test_train_cli_on_card(cuda, tmp_path, capsys):
    """train_gennbv for 2 iterations at 8 envs on the card: each kernel
    launches once for the setup reset and once per env step."""
    import json

    import chip_smoke
    from gennbv_tpu_torch.train import train_gennbv

    chip_smoke.reset_launches()
    train_gennbv.main([
        "--num_envs", "8", "--max_iterations", "2", "--log_dir", str(tmp_path),
        "--set", "env.camera.height=32", "--set", "env.camera.width=32",
        "--set", "env.renderer.resolution=16", "--set", "env.scene.num_scenes=8",
        "--set", "ppo.n_steps=8", "--set", "ppo.batch_size=16"])
    torch.cuda.synchronize()
    assert chip_smoke.launches() == chip_smoke.trained(
        chip_smoke.splat_expect(1 + 2 * 8))
    assert "final:" in capsys.readouterr().out
    (run,) = tmp_path.iterdir()
    logged = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [rec["step"] for rec in logged] == [1, 2]
    for rec in logged:
        assert all(np.isfinite(v) for v in rec.values())
        assert rec["train/n_minibatches"] >= 1


def test_training_reproduces_itself(cuda, tmp_path):
    """Three Runners from one seed, 2 iterations each at 8 envs with an
    eval and a checkpoint: two at pipeline depth 2 and one at depth 1.
    The same parameters, BatchNorm statistics, Adam state and logged
    metrics (but time/*), bit for bit."""
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.algo.runner import Runner
    from gennbv_tpu_torch.env import make_scenes
    from gennbv_tpu_torch.algo.repro import (first_difference, read_logged,
                                             snapshot)

    cfg = config.apply_overrides(config.Config(), (
        "env.num_envs=8", "env.camera.height=32", "env.camera.width=32",
        "env.renderer.resolution=16", "env.scene.num_scenes=8",
        "ppo.n_steps=8", "ppo.batch_size=16", "runner.eval_freq=2",
        "runner.save_freq=2"))
    assert cfg.runner.pipeline_depth == 2
    scenes = make_scenes(cfg.env.scene, 16)
    eval_scenes = make_scenes(config.SceneConfig(num_scenes=4, seed=100), 16)
    snaps = []
    for run, depth in enumerate((2, 2, 1)):
        log_dir = str(tmp_path / f"run{run}")
        runner = Runner(config.apply_overrides(
            cfg, (f"runner.pipeline_depth={depth}",)), scenes=scenes,
            eval_scenes=eval_scenes, log_dir=log_dir)
        runner.train(2)
        torch.cuda.synchronize()
        snaps.append(snapshot(runner, read_logged(log_dir)))
        runner.close()
    assert [rec["step"] for rec in snaps[0]["logged"]] == [1, 2]
    assert "eval/final_coverage" in snaps[0]["logged"][1]
    assert snaps[0]["count"] > 0
    assert first_difference(snaps[0], snaps[1]) is None
    assert first_difference(snaps[0], snaps[2]) is None


def test_dda_step_kernels_equal_plain(cuda):
    """The DDA step's shapes at 128^2 and R=64 on 16 scenes: the hit
    scatter of every pixel ([16, 16384] points) and the gather of the
    ray march's hit mask (a {0,1} image, 8000 voxel pixels an env), each
    bit-equal to its plain version with one launch a call."""
    import chip_smoke
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.env import make_scenes
    from gennbv_tpu_torch.ops import gather, scatter

    scenes = make_scenes(config.SceneConfig(num_scenes=16, seed=0), 64)
    (idx, valid), (fg, vi, ui) = chip_smoke._dda_step_inputs(
        scenes, config.CameraConfig(height=128, width=128))
    assert idx.shape == (16, 128 * 128, 3) and valid.any()
    assert set(fg.unique().tolist()) == {0.0, 1.0}
    chip_smoke.reset_launches()
    hits = scatter.scatter_cells_any(idx, valid, 20)
    free = gather.gather_image(fg, vi, ui)
    torch.cuda.synchronize()
    assert chip_smoke.launches() == {"gather_image": 1, "scatter_cells_any": 1,
                                     "zbuf_visible": 0, "zbuf_scatter_min": 0,
                                     "conv3d_wgrad": 0, "raymarch": 0}
    assert torch.equal(hits, scatter.scatter_cells_any_ref(idx, valid, 20))
    assert torch.equal(free, gather.gather_image_ref(fg, vi, ui))
    assert hits.sum() > 0 and free.sum() > 0


@pytest.mark.parametrize("carve_mode", ["ztest", "bresenham"])
def test_dda_env_on_card_matches_cpu(cuda, carve_mode):
    """renderer.mode=dda, 8 envs at 32^2, R=16, 6-step episodes: each step
    launches the hit scatter once and the gather twice (ztest) or never
    (bresenham), and envs 0-1 equal the same envs on the CPU over reset
    and 7 steps (an auto-reset among them): every field bit for bit, the
    grayscale frames to 1e-4."""
    import chip_smoke
    from gennbv_tpu_torch import config, spec
    from gennbv_tpu_torch.env import ReconEnv, make_scenes

    cfg = config.EnvConfig(
        num_envs=8, max_episode_length=6, carve_mode=carve_mode,
        camera=config.CameraConfig(height=32, width=32),
        renderer=config.RendererConfig(resolution=16, mode="dda"),
        scene=config.SceneConfig(num_scenes=4, seed=1))
    scenes = make_scenes(cfg.scene, 16)
    env = ReconEnv(cfg, scenes)
    cpu = ReconEnv(dataclasses.replace(cfg, num_envs=2),
                   chip_smoke._cpu_scenes(scenes))
    expect = chip_smoke.dda_expect(carve_mode)
    rng = np.random.default_rng(0)
    acts = torch.from_numpy(np.stack([rng.integers(0, k, (7, 8))
                                      for k in spec.NVEC], -1).astype(np.int32))
    chip_smoke.reset_launches()
    card = env.reset(8)
    assert chip_smoke.launches() == expect
    host = cpu.reset(2)
    for t in range(8):
        first = tuple(type(x)(*(y[:2] for y in x)) for x in card)
        chip_smoke._same_step(f"step {t}", first, host, 1e-4)
        if t == 7:
            break
        card = chip_smoke._step_counted(env, card[0], acts[t].cuda(), expect,
                                        f"step {t}")
        host = cpu.step(host[0], acts[t, :2])
    assert card[1].coverage.max() > 0


def test_exact_zbuf_env_on_card_matches_cpu(cuda):
    """renderer.zbuf_impl=scatter, 8 envs at 32^2, R=16, 6-step episodes:
    each step launches the scatter-min once, the gather twice and the hit
    scatter once, and envs 0-1 equal the same envs on the CPU over reset
    and 7 steps: every field bit for bit, the grayscale frames to 1e-4."""
    import chip_smoke
    from gennbv_tpu_torch import config, spec
    from gennbv_tpu_torch.env import ReconEnv, make_scenes

    cfg = config.EnvConfig(
        num_envs=8, max_episode_length=6,
        camera=config.CameraConfig(height=32, width=32),
        renderer=config.RendererConfig(resolution=16, zbuf_impl="scatter"),
        scene=config.SceneConfig(num_scenes=4, seed=1))
    scenes = make_scenes(cfg.scene, 16)
    env = ReconEnv(cfg, scenes)
    cpu = ReconEnv(dataclasses.replace(cfg, num_envs=2),
                   chip_smoke._cpu_scenes(scenes))
    expect = chip_smoke.exact_zbuf_expect(1)
    rng = np.random.default_rng(0)
    acts = torch.from_numpy(np.stack([rng.integers(0, k, (7, 8))
                                      for k in spec.NVEC], -1).astype(np.int32))
    chip_smoke.reset_launches()
    card = env.reset(8)
    assert chip_smoke.launches() == expect
    host = cpu.reset(2)
    for t in range(8):
        first = tuple(type(x)(*(y[:2] for y in x)) for x in card)
        chip_smoke._same_step(f"step {t}", first, host, 1e-4)
        if t == 7:
            break
        card = chip_smoke._step_counted(env, card[0], acts[t].cuda(), expect,
                                        f"step {t}")
        host = cpu.step(host[0], acts[t, :2])
    assert card[1].coverage.max() > 0


# ---------------------------------------------------------------------------
# the continuous-control path (the drone, Gaussian PPO, the on-policy runner)


def test_drone_steps_on_card_match_cpu(cuda):
    """Eight control steps of 64 drones from one state with the same
    actions on the card and on the CPU, with pushes off and no env done
    (so the state's generator, which differs between the devices, only
    reaches masked-out branches): tests/test_torch_drone.py's tolerance
    against JAX, 1e-5 relative and absolute."""
    from gennbv_tpu_torch.env.drone_robot import (DroneDomainRand, DroneRobot,
                                                  DroneRobotConfig)
    cfg = DroneRobotConfig(domain_rand=DroneDomainRand(push_robots=False))
    cpu, card = DroneRobot(cfg, device="cpu"), DroneRobot(cfg, device="cuda")
    cs, co = cpu.reset(64, torch.Generator().manual_seed(0))
    gs = cs._replace(**{f: getattr(cs, f).cuda() for f in cs._fields
                        if f != "rng"},
                     rng=torch.Generator(device="cuda").manual_seed(0).get_state())
    acts = torch.rand(8, 64, 4, generator=torch.Generator().manual_seed(1)) - 0.5
    for k in range(8):
        cs, co = cpu.step(cs, acts[k] * 0.6)
        gs, go = card.step(gs, acts[k].cuda() * 0.6)
        assert not co.done.any() and not go.done.any()
        for f in ("pos", "quat", "lin_vel", "ang_vel", "rotor_vel", "ep_reward"):
            np.testing.assert_allclose(getattr(gs, f).cpu().numpy(),
                                       getattr(cs, f).numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{f} at step {k}")
        np.testing.assert_allclose(go.obs.cpu().numpy(), co.obs.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(go.reward.cpu().numpy(), co.reward.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_continuous_update_on_card_matches_cpu(cuda):
    """One ppo_continuous update (5 epochs x 4 minibatches, adaptive KL) at
    a narrow width on the card and on the CPU from the same weights, data
    and minibatches: tests/test_torch_continuous.py's tolerances against
    JAX, and the same learning rate (float32 arithmetic on the same
    decisions)."""
    from gennbv_tpu_torch.algo import ppo_continuous as ppoc
    from gennbv_tpu_torch.models import gaussian
    from gennbv_tpu_torch.models.actor_critic import GaussianActorCritic

    g = torch.Generator().manual_seed(0)
    cpu = GaussianActorCritic(6, 3, (32, 32), (32, 32), generator=g, device="cpu")
    card = GaussianActorCritic(6, 3, (32, 32), (32, 32), device="cuda")
    card.load_state_dict(cpu.state_dict())
    m = 128
    obs = torch.randn(m, 6, generator=g)
    with torch.no_grad():
        out = cpu(obs)
        acts = gaussian.sample(out.mean, out.log_std, g)
        logp = gaussian.log_prob(out.mean, out.log_std, acts)
    old_mean = out.mean + 1e-2 * torch.randn(m, 3, generator=g)
    adv = torch.randn(m, generator=g)
    adv = (adv - adv.mean()) / adv.std(correction=0)
    data = (obs, None, acts, logp, out.value, old_mean,
            out.log_std.detach().clone(), adv,
            out.value + torch.randn(m, generator=g))
    cfg = ppoc.ContinuousPPOConfig(learning_rate=1e-3)
    idx = ppoc.minibatch_indices(cfg, m, torch.Generator().manual_seed(1))
    results = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        opt = ppoc.make_optimizer(cfg)
        state, metrics = ppoc.update(
            model, opt, cfg, opt.init(model),
            *(None if x is None else x.to(dev) for x in data),
            indices=idx.to(dev))
        results.append((model.state_dict(), state, metrics))
    (sd_c, st_c, m_c), (sd_g, st_g, m_g) = results
    for k, v in sd_c.items():
        assert sd_g[k].is_cuda
        np.testing.assert_allclose(sd_g[k].cpu().numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert st_c.count == st_g.count == 20
    assert float(st_c.learning_rate) == float(st_g.learning_rate)
    for moment, rtol, scale in (("mu", 1e-4, 1e-5), ("nu", 2e-4, 2e-5)):
        for k, v in getattr(st_c, moment).items():
            w = v.numpy()
            np.testing.assert_allclose(
                getattr(st_g, moment)[k].cpu().numpy(), w, rtol=rtol,
                atol=scale * float(np.abs(w).max()), err_msg=f"{moment} {k}")
    np.testing.assert_allclose([float(x) for x in m_g], [float(x) for x in m_c],
                               rtol=1e-5, atol=1e-7)


def test_continuous_training_reproduces_itself(cuda, tmp_path):
    """Two OnPolicyRunners from one seed on the drone, 2 iterations each
    at 256 envs: the same parameters, optimizer state and logged metrics
    (but time/*), bit for bit."""
    from gennbv_tpu_torch.algo import ppo_continuous as ppoc
    from gennbv_tpu_torch.algo.on_policy_runner import (OnPolicyRunner,
                                                        OnPolicyRunnerConfig)
    from gennbv_tpu_torch.algo.repro import (first_difference, read_logged,
                                             snapshot)
    from gennbv_tpu_torch.env.drone_robot import DroneRobot

    snaps = []
    for run in range(2):
        log_dir = str(tmp_path / f"run{run}")
        runner = OnPolicyRunner(
            DroneRobot(device="cuda"), ppoc.ContinuousPPOConfig(),
            OnPolicyRunnerConfig(num_steps_per_env=24, save_interval=0),
            num_envs=256, log_dir=log_dir, seed=1, actor_hidden=(64, 32),
            critic_hidden=(64, 32))
        runner.learn(2, log=True)
        torch.cuda.synchronize()
        snaps.append(snapshot(runner, read_logged(log_dir)))
    assert [rec["step"] for rec in snaps[0]["logged"]] == [1, 2]
    assert snaps[0]["count"] == 40
    assert first_difference(*snaps) is None


# ---------------------------------------------------------------------------
# the legged robots and the recurrent family


@pytest.mark.parametrize("robot", ["a1", "anymal_c", "cassie"])
def test_legged_steps_on_card_match_cpu(cuda, robot):
    """64 robots stepped 8 times with the same actions, each step on the
    CPU from a copy of the card's state before it (the explicit contacts
    are stiff: tests/test_torch_legged.py holds the port to JAX the same
    way): every field within 1e-3 of its largest magnitude, the contact,
    knee and done masks equal (chip_smoke.legged_on_cpu)."""
    import chip_smoke
    from gennbv_tpu_torch.env import legged_robot as lr
    env = lr.LeggedRobot(lr.ZOO[robot](), device="cuda")
    old = chip_smoke.RSL_CPU_ENVS
    chip_smoke.RSL_CPU_ENVS = 64
    try:
        chip_smoke.legged_on_cpu("card test", env, None, f"legged {robot}")
    finally:
        chip_smoke.RSL_CPU_ENVS = old


def test_rough_terrain_on_card_within_the_bound(cuda):
    """The rough terrain's hash and heights, and the height grid of 256
    robots stepped on the card, card against CPU (chip_smoke.phase_rough)."""
    import chip_smoke
    chip_smoke.phase_rough("card test")


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_recurrent_forward_on_card_matches_cpu(cuda, rnn_type):
    """RecurrentActorCritic at the runner's widths (256), 4 steps of 512
    envs with resets from the same weights on the card and the CPU:
    tests/test_torch_recurrent.py's forward tolerance against Flax, 1e-5
    relative and 1e-6 absolute."""
    from gennbv_tpu_torch.models.actor_critic import (RecurrentActorCritic,
                                                      hidden_leaves,
                                                      reset_hidden)
    g = torch.Generator().manual_seed(0)
    cpu = RecurrentActorCritic(48, 12, 256, rnn_type, (256,), (256,),
                               generator=g, device="cpu")
    card = RecurrentActorCritic(48, 12, 256, rnn_type, (256,), (256,),
                                device="cuda")
    card.load_state_dict(cpu.state_dict())
    hc, hg = cpu.initial_state(512), card.initial_state(512)
    with torch.no_grad():
        for t in range(4):
            obs = torch.randn(512, 48, generator=g)
            done = torch.rand(512, generator=g) < 0.2
            oc, hc = cpu(obs, hc)
            og, hg = card(obs.cuda(), hg)
            for a, b in ((og.mean, oc.mean), (og.value, oc.value),
                         *zip(hidden_leaves(hg), hidden_leaves(hc))):
                np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                           rtol=1e-5, atol=1e-6)
            hc, hg = reset_hidden(hc, done), reset_hidden(hg, done.cuda())


def test_recurrent_training_reproduces_itself(cuda):
    """Two RecurrentOnPolicyRunners from one seed on the A1, 2 iterations
    each at 256 envs: the same parameters, optimizer state and metrics
    (but time/*), bit for bit."""
    from gennbv_tpu_torch.algo import ppo_continuous as ppoc
    from gennbv_tpu_torch.algo.ppo_recurrent import RecurrentOnPolicyRunner
    from gennbv_tpu_torch.algo.repro import first_difference, snapshot
    from gennbv_tpu_torch.env.legged_robot import LeggedRobot

    snaps = []
    for _ in range(2):
        runner = RecurrentOnPolicyRunner(
            LeggedRobot(device="cuda"), ppoc.ContinuousPPOConfig(),
            num_steps_per_env=24, num_envs=256, seed=1, rnn_hidden=64,
            actor_hidden=(64,), critic_hidden=(64,))
        runner.learn(2)
        torch.cuda.synchronize()
        snaps.append(snapshot(runner, runner.logged))
    assert snaps[0]["count"] == 40
    assert first_difference(*snaps) is None


# ---------------------------------------------------------------------------
# the off-policy family


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_off_policy_update_on_card_matches_cpu(cuda, algo):
    """One update of a fresh learner (obs 17, 4 actions, the default
    widths and batch) on the card and on the CPU from the same state,
    batch and noises: tests/test_torch_off_policy.py's tolerances."""
    import chip_smoke
    from gennbv_tpu_torch.algo import replay_buffer as rb
    from gennbv_tpu_torch.algo.off_policy import (OffPolicyConfig,
                                                  OffPolicyLearner)

    g = torch.Generator(device="cuda").manual_seed(0)
    learner = OffPolicyLearner(OffPolicyConfig(algo=algo), 17, 4, g)
    n = learner.cfg.batch_size
    batch = rb.Batch(torch.randn(n, 17, device="cuda", generator=g),
                     torch.rand(n, 4, device="cuda", generator=g) * 2 - 1,
                     torch.randn(n, device="cuda", generator=g),
                     torch.randn(n, 17, device="cuda", generator=g),
                     (torch.rand(n, device="cuda", generator=g) < 0.1).float())
    noises = learner.draw_noises(n, g)
    chip_smoke.offpolicy_update_on_cpu(algo, learner, learner.state, batch,
                                       noises)


def test_dqn_update_on_card_matches_cpu(cuda):
    import chip_smoke
    from gennbv_tpu_torch.algo import replay_buffer as rb
    from gennbv_tpu_torch.algo.dqn import DQNConfig, DQNRunner
    from gennbv_tpu_torch.env.synthetic import IdentityEnvMultiDiscrete

    runner = DQNRunner(IdentityEnvMultiDiscrete(nvec=(4,)), DQNConfig(), 64)
    g = torch.Generator(device="cuda").manual_seed(0)
    n = runner.cfg.batch_size
    obs = torch.eye(4, device="cuda")[torch.randint(0, 4, (2, n), device="cuda",
                                                    generator=g)]
    batch = rb.Batch(obs[0], torch.randint(0, 4, (n, 1), device="cuda",
                                           generator=g, dtype=torch.int32),
                     torch.rand(n, device="cuda", generator=g), obs[1],
                     (torch.rand(n, device="cuda", generator=g) < 0.1).float())
    chip_smoke.dqn_update_on_cpu("dqn", runner, runner.state, batch)


def test_dqn_training_reproduces_itself(cuda):
    """Two DQNRunners from one seed at 1,024 envs, 64 env steps each (a
    gradient step each, across a target sync at 50): the same parameters,
    target, Adam state and buffer, bit for bit."""
    import chip_smoke
    from gennbv_tpu_torch.algo.dqn import DQNConfig, DQNRunner
    from gennbv_tpu_torch.env.synthetic import IdentityEnvMultiDiscrete

    snaps = []
    for _ in range(2):
        runner = DQNRunner(IdentityEnvMultiDiscrete(nvec=(4,)),
                           DQNConfig(target_update_interval=50), 1024, seed=1)
        runner.learn(64, chunk=16)
        assert runner.state.grad_steps == 64
        snaps.append({**chip_smoke.flat_state(runner.state, "state"),
                      **chip_smoke.flat_state(runner.buffer, "buffer")})
    assert chip_smoke._first_unequal(*snaps) is None


def test_sample_relabeled_on_card_matches_cpu(cuda):
    """A buffer of random rounds with in-round boundaries, relabeled on
    the card and on the CPU from the same draws: bit for bit."""
    import chip_smoke
    from gennbv_tpu_torch.algo import her
    from gennbv_tpu_torch.env.synthetic import GoalPointEnv

    g = torch.Generator(device="cuda").manual_seed(0)
    buf = her.init_episode_buffer(64, 8, 6, 2, device="cuda")
    for _ in range(3):
        done = (torch.rand(32, 8, device="cuda", generator=g) < 0.3).float()
        buf = her.add_episodes(
            buf, torch.randn(32, 9, 6, device="cuda", generator=g),
            torch.rand(32, 8, 2, device="cuda", generator=g) * 2 - 1, done,
            done * (torch.rand(32, 8, device="cuda", generator=g) < 0.5))
    assert torch.equal(buf.seg_end.cpu(), her.segment_ends(buf.done.cpu()))
    draws = her.draw_relabel_indices(buf.size, 512, 8, g)
    cfg = her.HERConfig()
    got = her.relabel(buf, draws, 2, GoalPointEnv(dim=2).compute_reward, cfg)
    want = her.relabel(chip_smoke.to_device(buf, "cpu"),
                       chip_smoke.to_device(draws, "cpu"), 2,
                       GoalPointEnv(dim=2, device="cpu").compute_reward, cfg)
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_full_width_draws_equal_multinomial_on_card(cuda):
    """distributions.sample's argmax(p / Exp(1)) is torch.multinomial's
    draw from the same generator; a slice of the rows drawn at full width
    keeps the full batch's draws for its rows."""
    from gennbv_tpu_torch import spec
    from gennbv_tpu_torch.models import distributions
    logits = torch.randn(256, spec.NUM_LOGITS, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    got = distributions.sample(logits, torch.Generator("cuda").manual_seed(1))
    gen = torch.Generator("cuda").manual_seed(1)
    want = torch.stack([torch.multinomial(torch.softmax(c, -1), 1,
                                          generator=gen)[:, 0]
                        for c in torch.split(logits, spec.NVEC, -1)], -1)
    assert torch.equal(got, want.to(torch.int32))
    rows = slice(64, 128)
    part = distributions.sample(logits[rows], torch.Generator(
        "cuda").manual_seed(1), rows, 256)
    assert torch.equal(part, got[rows])


def test_mesh_update_on_one_card_over_nccl(cuda, tmp_path):
    """tests/test_torch_mesh.py's one update at W = 1 over nccl (a FileStore
    group of one, the captured CUDA graph with its collectives) against
    the update without a mesh on the card."""
    import os
    import torch.distributed as dist
    import torch_mesh_ranks as R
    cfg = R.tiny(num_devices=1)
    want = R.update_case("cuda", R.one_process(cfg))
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        got = R.update_case("cuda", cfg)
    finally:
        dist.destroy_process_group()
    R.held_update(got, want)

