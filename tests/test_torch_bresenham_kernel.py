"""Tests of the Bresenham carve's CUDA kernel (``csrc/bresenham.cu``
through ``ops/bresenham.py``, ``carve.bresenham_traversed`` on CUDA
tensors): its mask bit for bit that of the plain loop
(``carve.bresenham_traversed_ref``) run on the same card and of the
benchmark's closed form (``benchmark/reference/env_exact.bresenham``),
over random hit grids at several N and G, cameras inside, on the faces of
and far outside the grid (one beyond the 3G cap), ties between the axes,
zero-length rays, no valid target, both target layouts, the held-out
eval's steps on its trained policy, and a CUDA graph; and its counters.
Those skip on a machine without a card.  The tests at the end run on the
CPU: the wrapper refuses CPU tensors, a CPU carve launches nothing, and
the benchmark's fault hook still reaches the carve through
``carve.bresenham_traversed``.  This file imports no jax, so where jax is
missing run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bresenham_kernel.py
"""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib

import pytest
import torch

from benchmark.reference import env_exact
from gennbv_tpu_torch import config, spec
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.ops import bresenham, carve, kernels
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import WorkCounter


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _grid_targets(g: int, device="cuda") -> torch.Tensor:
    """Every voxel of the G^3 grid, in carve_bresenham's order."""
    ar = torch.arange(g, dtype=torch.int32, device=device)
    return torch.cartesian_prod(ar, ar, ar)


def _held(src, targets, valid, g) -> torch.Tensor:
    """The kernel's mask (through ``carve.bresenham_traversed``) against
    the plain loop's on the card, bit for bit, and, where the targets are
    the whole grid, against the benchmark's closed form; one launch
    counted a call.  Returns the mask."""
    before = kernels.launches()["bresenham"]
    got = carve.bresenham_traversed(src, targets, valid, g)
    assert kernels.launches()["bresenham"] == before + 1
    want = carve.bresenham_traversed_ref(src, targets, valid, g)
    n = src.shape[0]
    assert got.dtype == torch.float32 and got.shape == (n, g, g, g)
    assert torch.equal(got, want)
    if targets.shape == (g ** 3, 3) and torch.equal(targets,
                                                    _grid_targets(g)):
        closed = env_exact.bresenham(valid.float().reshape(n, g, g, g),
                                     src.long(), g)
        assert torch.equal(got, closed)
    return got


def _sources(g: int) -> torch.Tensor:
    """Cameras inside the grid, on its faces and corners, just outside,
    far above (as the eval's cameras are) and beyond the 3G cap."""
    return torch.tensor([
        [g // 2, g // 3, g - 2], [0, 0, 0], [g - 1, g - 1, g - 1],
        [0, g // 2, g // 2], [g // 2, g - 1, g // 3], [-1, g // 2, g],
        [g // 2, g // 2, 2 * g], [-2 * g, 3 * g // 2, -g],
        [g // 2, g // 2, 4 * g], [-5 * g, 1, 2]], dtype=torch.int32,
        device="cuda")


@pytest.mark.parametrize("n,g,density", [(10, 8, 0.3), (10, 20, 0.03),
                                         (50, 20, 0.01), (10, 33, 0.01),
                                         (3, 1, 1.0)])
def test_kernel_equals_plain_on_random_hit_grids(cuda, n, g, density):
    """Random hit grids, every target slot of the grid, the cameras of
    _sources (repeated to n envs); G 1, 8, 20 and 33 (a CTA's 128
    threads do not divide 33^3 slots)."""
    gen = torch.Generator(device="cuda").manual_seed(n * g)
    src = _sources(g)[torch.arange(n, device="cuda") % 10]
    valid = torch.rand(n, g ** 3, device="cuda", generator=gen) < density
    got = _held(src, _grid_targets(g), valid, g)
    if g > 1:
        assert got.sum() > valid.sum() / 2


def test_the_3g_cap_ends_far_rays(cuda):
    """A camera 5G voxels from the grid: each ray ends after its 3G = 60
    points, all outside the grid, so its env carves nothing, where the
    rays of a camera inside the grid reach every target."""
    g = 20
    src = torch.tensor([[-5 * g, 3, 4], [g // 2, g // 2, g // 2]],
                       dtype=torch.int32, device="cuda")
    valid = torch.ones(2, g ** 3, dtype=torch.bool, device="cuda")
    got = _held(src, _grid_targets(g), valid, g)
    assert int(got[0].sum()) == 0 and bool(got[1].all())
    # a camera just beyond the cap's reach carves only the near face
    src = torch.tensor([[-3 * g + 1, 3, 4]], dtype=torch.int32, device="cuda")
    got = _held(src, _grid_targets(g), valid[:1], g)
    assert bool(got[0, 0].any()) and not bool(got[0, 1:].any())


def test_kernel_equals_plain_on_axis_ties(cuda):
    """Targets on the diagonals through each camera: dx = dy = dz, dx = dy
    and dy = dz, where the tie-break order picks the dominant axis."""
    g = 20
    src = torch.tensor([[0, 0, 0], [19, 19, 19], [5, 5, 5], [10, 3, -4]],
                       dtype=torch.int32, device="cuda")
    valid = torch.zeros(4, g, g, g, dtype=torch.bool, device="cuda")
    span = torch.arange(-g, g, device="cuda")
    zero = torch.zeros_like(span)
    for k in range(4):
        for step in ((span, span, span), (span, span, zero),
                     (zero, span, span), (span, zero, span)):
            p = src[k].long() + torch.stack(step, -1)
            p = p[((p >= 0) & (p < g)).all(-1)]
            valid[k, p[:, 0], p[:, 1], p[:, 2]] = True
    _held(src, _grid_targets(g), valid.reshape(4, -1), g)


def test_zero_length_rays_mark_the_camera_voxel(cuda):
    """A target on the camera's own voxel marks that voxel alone."""
    g = 20
    src = torch.tensor([[3, 7, 11], [0, 19, 0]], dtype=torch.int32,
                       device="cuda")
    valid = torch.zeros(2, g, g, g, dtype=torch.bool, device="cuda")
    valid[0, 3, 7, 11] = valid[1, 0, 19, 0] = True
    got = _held(src, _grid_targets(g), valid.reshape(2, -1), g)
    assert torch.equal(got, valid.float())


def test_no_valid_target_carves_nothing(cuda):
    g = 20
    valid = torch.zeros(3, g ** 3, dtype=torch.bool, device="cuda")
    got = _held(_sources(g)[:3], _grid_targets(g), valid, g)
    assert not got.any()


@pytest.mark.parametrize("layout", ["shared", "shared_batched", "per_env"])
def test_kernel_takes_both_target_layouts(cuda, layout):
    """Targets [R, 3] (read with a stride of 0), [1, R, 3], and [N, R, 3]
    of each env's own random voxels; int64 targets and sources are taken
    as the loop takes them; a shape that fits neither is refused."""
    g, n, r = 20, 10, 777
    gen = torch.Generator(device="cuda").manual_seed(7)
    src = _sources(g)
    if layout == "per_env":
        targets = torch.randint(0, g, (n, r, 3), device="cuda",
                                generator=gen, dtype=torch.int32)
    else:
        targets = torch.randint(0, g, (r, 3), device="cuda", generator=gen,
                                dtype=torch.int32)
        if layout == "shared_batched":
            targets = targets[None]
    valid = torch.rand(n, r, device="cuda", generator=gen) < 0.5
    got = _held(src, targets, valid, g)
    assert got.any()
    _held(src.long(), targets.long(), valid, g)
    # targets of another env count or row count are refused
    for wrong in (targets.reshape(-1, r, 3)[:1].expand(2, r, 3),
                  targets.reshape(-1, 3)[1:]):
        with pytest.raises(ValueError, match="do not fit"):
            bresenham.bresenham(src, wrong, valid, g)


def _eval_carves():
    """The arguments of every ``carve.bresenham_traversed`` call of one
    held-out eval episode of ``dda400.eval`` (50 envs, 400x400, the eval's
    50 scenes, the configuration's trained policy): the reset's and the
    30 steps'."""
    from benchmark import harness
    from benchmark.loops import eval_exact
    cell = harness.find_cell(harness.load_spec(), "dda400.eval")
    loop = eval_exact.Loop(cell, 2300000023, "cuda")
    loop.setup(0.0)
    calls = []
    traversed = carve.bresenham_traversed

    def kept(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return traversed(*args)

    carve.bresenham_traversed = kept
    try:
        loop._episode()
    finally:
        carve.bresenham_traversed = traversed
    return calls


def test_kernel_equals_plain_at_the_held_out_eval_steps(cuda):
    """Every carve of a dda400.eval episode (the trained policy's poses,
    50 x 20^3 target slots, the march's hits): bit-equal."""
    calls = _eval_carves()
    assert len(calls) == 1 + spec.MAX_EPISODE_LENGTH_EVAL
    for src, targets, valid, g in calls:
        assert src.shape == (spec.EVAL_NUM_ENVS, 3) and g == 20
        assert targets.shape == (g ** 3, 3) and valid.any()
        _held(src, targets, valid, g)


def test_kernel_in_a_cuda_graph(cuda):
    """A call captured in a CUDA graph: each replay carves the rays the
    static inputs hold then, bit-equal to an eager call."""
    g = 20
    src = _sources(g)
    targets = _grid_targets(g)
    valid = torch.rand(10, g ** 3, device="cuda") < 0.05
    carve.bresenham_traversed(src, targets, valid, g)      # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = carve.bresenham_traversed(src, targets, valid, g)
    for seed in (1, 2):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        valid.copy_(torch.rand(valid.shape, device="cuda", generator=gen)
                    < 0.05 * seed)
        src.add_(seed)
        graph.replay()
        want = carve.bresenham_traversed_ref(src, targets, valid, g)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and out.any()


def test_carve_bresenham_captured_before_its_table_is_kept(cuda):
    """``carve_bresenham`` captured in a CUDA graph at a grid size whose
    target table was never made: the capture makes its own table and
    keeps none, so the replays and a later eager call both carve the
    plain loop's mask."""
    g = 17
    assert (g, torch.device("cuda", 0)) not in carve._GRID_VOXELS
    src = _sources(g)
    hit = (torch.rand(10, g, g, g, device="cuda") < 0.05).float()
    # the kernel built and loaded by a call at another grid size
    carve.carve_bresenham(hit[:, :5, :5, :5].contiguous(), src, 5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = carve.carve_bresenham(hit, src, g)
    assert (g, torch.device("cuda", 0)) not in carve._GRID_VOXELS
    graph.replay()
    want = carve.bresenham_traversed_ref(src, _grid_targets(g),
                                         hit.reshape(10, -1) > 0.5, g)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and out.any()
    assert torch.equal(carve.carve_bresenham(hit, src, g), want)
    assert torch.equal(carve._GRID_VOXELS[(g, torch.device("cuda", 0))],
                       _grid_targets(g))


def test_kernel_counters(cuda):
    """``kernel/bresenham/launches`` counts one a call, traced or not;
    while spans record ``carve/bresenham_rays`` adds the valid rays, and
    off it counts nothing; inside a WorkCounter the call adds
    ``bresenham.work``'s operations."""
    g = 20
    src, targets = _sources(g), _grid_targets(g)
    valid = torch.rand(10, g ** 3, device="cuda") < 0.05
    args = (src, targets, valid, g)

    def rays():
        return profiling.counters("carve/").get("carve/bresenham_rays", 0)

    before, launched = rays(), kernels.launches()["bresenham"]
    with profiling.tracing():
        carve.bresenham_traversed(*args)
        carve.bresenham_traversed(*args)
    after = rays()
    assert after == before + 2 * int(valid.sum())
    assert kernels.launches()["bresenham"] == launched + 2
    carve.bresenham_traversed(*args)
    assert rays() == after
    assert kernels.launches()["bresenham"] == launched + 3
    nbytes, ops = bresenham.work(*args)
    with WorkCounter() as counted:
        bresenham.bresenham(*args)
    assert counted.flops == ops > 0 and counted.bytes >= nbytes


# --- on the CPU -------------------------------------------------------------

def _cpu_case(g: int = 6):
    gen = torch.Generator().manual_seed(g)
    src = torch.tensor([[1, 2, 3], [-4, 2, 9]], dtype=torch.int32)
    valid = torch.rand(2, g ** 3, generator=gen) < 0.2
    return src, _grid_targets(g, "cpu"), valid, g


def test_the_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only, as ``ops/raymarch.py``
    does; the CPU's carve is the plain loop."""
    with pytest.raises(ValueError, match="CUDA"):
        bresenham.bresenham(*_cpu_case())


@pytest.mark.parametrize("traced", [False, True])
def test_a_cpu_carve_launches_no_kernel(traced):
    """On the CPU ``bresenham_traversed`` is the plain loop, bit for bit,
    and ``kernels.launches()`` reports the Bresenham kernel at 0, traced
    or not."""
    args = _cpu_case()
    kernels.reset_launches()
    with profiling.tracing() if traced else contextlib.nullcontext():
        got = carve.bresenham_traversed(*args)
        carve.carve_bresenham(args[2].float().reshape(2, 6, 6, 6), args[0], 6)
    assert torch.equal(got, carve.bresenham_traversed_ref(*args))
    assert kernels.launches()["bresenham"] == 0
    assert set(kernels.launches().values()) == {0}


def test_the_grid_voxels_are_made_once():
    """``carve.grid_voxels`` gives every voxel of the grid in C order,
    one table a (G, device), which ``carve_bresenham`` carves to."""
    table = carve.grid_voxels(6, "cpu")
    assert table is carve.grid_voxels(6, torch.device("cpu"))
    assert table.dtype == torch.int32
    assert torch.equal(table, _grid_targets(6, "cpu"))
    src, targets, valid, g = _cpu_case()
    assert torch.equal(
        carve.carve_bresenham(valid.float().reshape(2, g, g, g), src, g),
        carve.bresenham_traversed_ref(src, targets, valid, g))


def test_the_work_count_of_a_call():
    """``bresenham.work``: a byte a flag, 12 bytes a camera and a target
    row, 4 a cell of the mask; OPS_PER_POINT a point of each valid ray,
    min(its largest distance, 3G - 1) + 1 points."""
    g = 10
    src = torch.tensor([[0, 0, 0], [-100, 0, 0]], dtype=torch.int32)
    targets = torch.tensor([[0, 0, 0], [3, 1, 2], [9, 9, 9]],
                           dtype=torch.int32)
    valid = torch.tensor([[True, True, False], [False, True, True]])
    points = (1 + 4) + (3 * g + 3 * g)
    assert bresenham.work(src, targets, valid, g) == (
        6 + 12 * (2 + 3) + 4 * 2 * g ** 3, bresenham.OPS_PER_POINT * points)


def test_the_fault_hook_reaches_the_carve():
    """``benchmark/faults_exact.carve_dropped`` patches
    ``carve.bresenham_traversed``: a tiny "dda" env with the Bresenham
    carve marks no voxel free under it (reset and a step), where it marks
    some without it."""
    from benchmark import faults_exact
    cfg = config.EnvConfig(
        num_envs=3, max_episode_length=4, carve_mode="bresenham",
        camera=config.CameraConfig(height=16, width=16),
        renderer=config.RendererConfig(mode="dda", resolution=16),
        scene=config.SceneConfig(num_scenes=2, seed=0))
    env = ReconEnv(cfg, make_scenes(cfg.scene, 16, "cpu"))

    def free_cells():
        state, _ = env.reset(3)
        state, _ = env.step(state, env.init_action.expand(3, -1))
        return int((state.tri_grid < 0).sum())

    assert free_cells() > 0
    with faults_exact.carve_dropped():
        assert free_cells() == 0
    assert free_cells() > 0
