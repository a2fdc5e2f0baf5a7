"""Tests of the ray march's CUDA kernel (``csrc/raymarch.cu`` through
``ops/raymarch.py``, ``render.raymarch`` on CUDA tensors): its depth and
hit bit for bit those of the plain loop (``render.raymarch_ref``) run on
the same card and of the benchmark's own march
(``benchmark/reference/env_exact.march``), over random grids, rays from
inside and outside the box, axis-parallel and guarded directions, rays
through voxel edges and corners, rays that miss, a step cap below the
longest ray, leading shapes, a ray count off the CTA's multiple, a call at
the held-out eval's step, and a CUDA graph; and its counters.  They skip
on a machine without a card.  This file imports no jax, so where jax is
missing run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_raymarch_kernel.py
"""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import itertools

import pytest
import torch

from benchmark.reference import env_exact
from gennbv_tpu_torch.ops import kernels, render
from gennbv_tpu_torch.utils import profiling

DEPTH_MAX = 30.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _held(occ, lo, hi, origin, dirs, r, cap, depth_max=DEPTH_MAX):
    """The kernel's (depth, hit) against the plain loop's on the card, bit
    for bit (a -0.0 depth included), and against the exact march; one
    launch counted a call.  Returns (hit, the exact march's reads [B, P]),
    the leading shape flattened."""
    args = (occ, lo, hi, origin, dirs, r, cap, depth_max)
    before = kernels.launches()["raymarch"]
    depth, hit = render.raymarch(*args)
    assert kernels.launches()["raymarch"] == before + 1
    want_depth, want_hit = render.raymarch_ref(*args)
    assert depth.shape == want_depth.shape == dirs.shape[:-1]
    assert torch.equal(depth.view(torch.int32), want_depth.view(torch.int32))
    assert torch.equal(hit, want_hit)
    p = dirs.shape[-2]
    b = dirs.numel() // (3 * p)
    x_depth, x_hit, reads = env_exact.march(
        occ.reshape(b, -1), lo.reshape(b, 3), hi.reshape(b, 3),
        origin.reshape(b, 3), dirs.reshape(b, p, 3), r, cap, depth_max)
    assert torch.equal(depth.reshape(b, p), x_depth)
    assert torch.equal(hit.reshape(b, p), x_hit)
    return hit.reshape(b, p), reads


def _random_case(r: int, p: int, seed: int, density: float = 0.03):
    """Three envs with boxes of their own and random grids: env 0's origin
    inside its box, env 1's beside it, env 2's far above it; normal
    directions with planted ones: the six axes, zero and guarded
    components (|d| < 1e-9, of both signs), and rays pointing away."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    occ = (torch.rand(3, r ** 3, device="cuda", generator=g) < density
           ).to(torch.uint8)
    lo = torch.tensor([[-4.0, -4.0, 0.0], [0.0, 0.0, 0.0],
                       [-10.5, 3.25, -1.0]], device="cuda")
    hi = lo + torch.tensor([[8.0, 8.0, 8.0], [5.0, 7.0, 3.0],
                            [13.0, 2.5, 6.0]], device="cuda")
    origin = torch.stack([(lo[0] + hi[0]) / 2 + 0.3,
                          torch.tensor([-1.5, 3.0, 1.2], device="cuda"),
                          (lo[2] + hi[2]) / 2 + torch.tensor(
                              [0.0, 0.0, 20.0], device="cuda")])
    dirs = torch.randn(3, max(p, 21), 3, device="cuda", generator=g)
    dirs[:, :6] = torch.cat([torch.eye(3), -torch.eye(3)]).cuda()
    dirs[:, 6:9, 1] = 0.0
    dirs[:, 9:12, 0] = -0.0
    dirs[:, 12:15, 2] = 5e-10
    dirs[:, 15:18, 2] = -5e-10
    dirs[:, 18:21, 0] = 2e-9
    return occ, lo, hi, origin, dirs[:, :p].contiguous()


@pytest.mark.parametrize("r,p", [(16, 1000), (64, 1000), (64, 129), (16, 1)])
def test_kernel_equals_plain_on_random_grids(cuda, r, p):
    """R 16 and 64; 1,000 rays (not a multiple of the CTA's 128), 129 and
    1; every ray's depth and hit bit-equal; some rays hit, some miss."""
    occ, lo, hi, origin, dirs = _random_case(r, p, r + p)
    hit, reads = _held(occ, lo, hi, origin, dirs, r, 3 * r)
    if p > 1:
        assert hit.any() and not hit.all()
        assert (reads == 0).any(), "some rays miss the box"


def _lattice_case(r: int):
    """Rays from voxel corners and voxel centres of a grid of unit voxels
    ([0, R]^3, so crossings tie exactly), in every direction made of the
    components -1, -0.5, -1e-8, -1e-10, -0.0, 0.0, 1e-10, 1e-8, 0.5 and 1:
    ties of two and three axes in t_max, crossings at t = +-0, guarded
    components of both signs."""
    comps = [-1.0, -0.5, -1e-8, -1e-10, -0.0, 0.0, 1e-10, 1e-8, 0.5, 1.0]
    dirs = torch.tensor(list(itertools.product(comps, repeat=3)),
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(r)
    occ = (torch.rand(4, r ** 3, device="cuda", generator=g) < 0.2
           ).to(torch.uint8)
    lo = torch.zeros(4, 3, device="cuda")
    hi = torch.full((4, 3), float(r), device="cuda")
    c = r // 2
    origin = torch.tensor([[c, c, c], [c + 0.5, c + 0.5, c + 0.5],
                           [c, c + 0.5, 1.0], [0.0, 0.0, 0.0]],
                          device="cuda")
    return occ, lo, hi, origin, dirs.expand(4, -1, -1).contiguous()


@pytest.mark.parametrize("r", [16, 64])
def test_kernel_equals_plain_through_edges_and_corners(cuda, r):
    occ, lo, hi, origin, dirs = _lattice_case(r)
    hit, _ = _held(occ, lo, hi, origin, dirs, r, 3 * r)
    assert hit.any() and not hit.all()
    # an empty grid: every ray runs to its exit from the grid
    hit, reads = _held(torch.zeros_like(occ), lo, hi, origin, dirs, r, 3 * r)
    assert not hit.any() and int(reads.max()) > r


def test_kernel_equals_plain_under_a_step_cap(cuda):
    """A cap of 5 steps, below most rays' length in a sparse grid: rays
    stop at the cap without a hit, as the loop stops them."""
    occ, lo, hi, origin, dirs = _random_case(64, 1000, 7, density=0.002)
    _, full = _held(occ, lo, hi, origin, dirs, 64, 192)
    _, capped = _held(occ, lo, hi, origin, dirs, 64, 5)
    assert int(full.max()) > 5 and int(capped.max()) == 5
    assert torch.equal(capped, full.clamp_max(5))
    _, none = _held(occ, lo, hi, origin, dirs, 64, 0)
    assert int(none.sum()) == 0


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_kernel_takes_any_leading_shape(cuda, lead):
    """One camera (no batch axis), [B] and [S, M] leading shapes, as
    render_depth's callers pass them: occupancy [..., R^3] in uint8, bool
    and float32 (solid where > 0)."""
    r, p = 16, 300
    occ, lo, hi, origin, dirs = _random_case(r, p, 11, density=0.05)
    n = max(1, torch.Size(lead).numel())
    pick = torch.arange(n, device="cuda") % 3
    shaped = [x[pick].reshape(*lead, *x.shape[1:])
              for x in (occ, lo, hi, origin, dirs)]
    hit, _ = _held(*shaped, r, 3 * r)
    assert hit.any()
    for occ_as in (shaped[0].bool(), shaped[0].float() * 2.0 - 0.5):
        _held(occ_as, *shaped[1:], r, 3 * r)


def test_kernel_equals_plain_at_the_held_out_eval_step(cuda):
    """One call at dda400.eval's step: 50 envs x 160,000 rays of the
    400x400 camera, R 64, 192 steps, the eval's 50 scenes (seed 100) each
    from a pose of the action grid; bit-equal, its reads counted."""
    import chip_smoke
    from gennbv_tpu_torch import config
    scenes = chip_smoke.make_path_scenes(chip_smoke.eval_config("pallas"),
                                         "held-out")
    cam = config.CameraConfig(height=400, width=400)
    args = chip_smoke.march_args(scenes, cam)
    assert args[4].shape == (50, 160_000, 3) and args[5:7] == (64, 192)
    reads = chip_smoke.march_held("dda400.eval's step", args)
    assert 0 < int(reads.sum()) < 192 * reads.numel()


def test_kernel_in_a_cuda_graph(cuda):
    """A call captured in a CUDA graph: each replay marches the rays the
    static inputs hold then, bit-equal to an eager call."""
    r, p = 64, 1000
    occ, lo, hi, origin, dirs = _random_case(r, p, 3)
    args = (occ, lo, hi, origin, dirs, r, 3 * r, DEPTH_MAX)
    render.raymarch(*args)                      # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        depth, hit = render.raymarch(*args)
    for seed in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dirs.copy_(torch.randn(dirs.shape, device="cuda", generator=g))
        origin[:, 2] += 0.25 * seed
        graph.replay()
        want = render.raymarch(*args)
        torch.cuda.synchronize()
        assert torch.equal(depth.view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(hit, want[1]) and hit.any()


def test_kernel_counters(cuda):
    """``kernel/raymarch/launches`` counts one a call, traced or not;
    while spans record ``raymarch/voxel_reads`` adds the exact march's
    reads; off, it counts nothing; ``raymarch/iterations`` and
    ``raymarch/syncs``, the loop's, never move on the kernel path."""
    r = 64
    occ, lo, hi, origin, dirs = _random_case(r, 1000, 5)
    args = (occ, lo, hi, origin, dirs, r, 3 * r, DEPTH_MAX)
    _, _, reads = env_exact.march(*args)
    names = ("raymarch/voxel_reads", "raymarch/iterations", "raymarch/syncs")

    def counted():
        c = profiling.counters("raymarch/")
        return {k: c.get(k, 0) for k in names}

    before, launched = counted(), kernels.launches()["raymarch"]
    with profiling.tracing():
        render.raymarch(*args)
        render.raymarch(*args)
    after = counted()
    assert after == {**before, "raymarch/voxel_reads":
                     before["raymarch/voxel_reads"] + 2 * int(reads.sum())}
    assert kernels.launches()["raymarch"] == launched + 2
    render.raymarch(*args)
    assert counted() == after
    assert kernels.launches()["raymarch"] == launched + 3
