"""Microbenchmarks of the env step's hot ops on the card (port of
``tools/bench_scatter.py``): PyTorch's scatter and gather calls beside
their one-hot matrix-product forms, and the port's hand-written
scatter-min z-buffer kernel (``csrc/zbuf_scatter_min.cu``) where the TPU
tool had its Pallas kernel.

    python -m gennbv_tpu_torch.tools.bench_scatter [num_envs] [Q] [cam]
    python -m gennbv_tpu_torch.tools.bench_scatter 4 64 8 --device cpu

Defaults: 256 envs, Q = 11264 points an env, a 128x128 camera, on the
card; the inputs are the TPU tool's, drawn from numpy's RandomState(0) in
the same order.  Sections, each form on its own line with its ms a call:

- zbuf: the exact per-pixel min depth [N, cam^2] (fill 50) of
  ``flat = vi * cam + ui`` and ``where(ok, z, 50)`` by the library
  scatter-min (``scatter_reduce_``, amin), by 64-level count products, and
  by the hand kernel; the kernel's exactness and the count form's error
  against the library's;
- hits: the {0, 1} grid [N, 20^3] of the points' cells by the library
  scatter-max and by one-hot products, and their exactness;
- carve: a [N, cam, cam] image gathered at 20^3 pixels by the library
  gather and by one-hot products (bf16), and the error;
- vis: a [N, cam^2] image gathered at the Q points by the library gather
  and by one flat take.

On the card each time is the mean over 20 back-to-back calls between two
CUDA events after 3 warm-up calls, and the card's name and power limit
are printed first.  With ``--device cpu`` the same forms run on the CPU
(the kernel's plain version in place of the kernel), timed on the host
clock: those are no device times.  This tool adds no metric; the port's
kernels are timed at the paths' shapes by ``chip_smoke.py`` phase 3.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gennbv_tpu_torch.ops import zbuf_scatter
from gennbv_tpu_torch.utils.device import card_line

DMAX = 50.0
LEVELS = 64                  # depth levels of the count-product z-buffer
G = 20                       # the hit grid's side
ITERS, WARMUP = 20, 3


def _timed(device: torch.device, fn, *args) -> tuple[object, float]:
    """fn(*args) and its ms a call: CUDA events around ITERS calls on the
    card, the host clock on the CPU, after WARMUP calls."""
    for _ in range(WARMUP):
        out = fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn(*args)
    return out, (time.perf_counter() - t0) / ITERS * 1e3


def _chunks(n: int, size: int):
    return [slice(s, min(n, s + size)) for s in range(0, n, size)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("num_envs", type=int, nargs="?", default=256)
    p.add_argument("q", type=int, nargs="?", default=11264)
    p.add_argument("cam", type=int, nargs="?", default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n, q, cam = args.num_envs, args.q, args.cam
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_scatter: no CUDA device (pass --device cpu "
                             "for the CPU)")
        print(f"card: {card_line()}", flush=True)
    else:
        print(f"device: {device} (host clock; no device times)", flush=True)
    hw = cam * cam
    rng = np.random.RandomState(0)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    vi = t(rng.randint(0, cam, (n, q)), torch.int32)
    ui = t(rng.randint(0, cam, (n, q)), torch.int32)
    z = t(rng.uniform(1.0, 30.0, (n, q)), torch.float32)
    ok = t(rng.rand(n, q) < 0.7, torch.bool)
    print(f"n={n} Q={q} cam={cam}", flush=True)
    ms: dict[str, float] = {}

    def bench(name, fn, *a):
        out, ms[name] = _timed(device, fn, *a)
        print(f"{name:44s} {ms[name]:8.4f} ms", flush=True)
        return out

    # ---------------- zbuf scatter-min (the splat's z-buffer) ----------------
    def zbuf_library(vi, ui, z, ok):
        flat = (vi * cam + ui).long()
        out = torch.full((n, hw), DMAX, dtype=torch.float32, device=device)
        return out.scatter_reduce_(1, flat, torch.where(ok, z, DMAX),
                                   reduce="amin")

    ref = bench("zbuf: library scatter-min (scatter_reduce_)", zbuf_library,
                vi, ui, z, ok)

    levels_u = torch.arange(cam * LEVELS, device=device)
    rows = torch.arange(cam, device=device)

    def zbuf_counts(vi, ui, z, ok):
        """D depth levels folded into the u axis of one product, 8 envs at
        a time: the first level a pixel's count reaches, at its midpoint."""
        out = []
        for s in _chunks(n, 8):
            v, u, zz, o = vi[s], ui[s], z[s], ok[s]
            zmin = torch.where(o, zz, torch.inf).amin(-1, keepdim=True)
            zmax = torch.where(o, zz, -torch.inf).amax(-1, keepdim=True)
            span = torch.clamp_min(zmax - zmin, 1e-3)
            d = torch.clamp(((zz - zmin) / span * LEVELS).int(), 0, LEVELS - 1)
            ohv = (v[:, None, :] == rows[None, :, None]) & o[:, None, :]
            ohud = (u * LEVELS + d)[:, :, None] == levels_u
            counts = torch.bmm(ohv.to(torch.bfloat16), ohud.to(torch.bfloat16))
            have = counts.reshape(-1, cam, cam, LEVELS) > 0.5
            first = torch.argmax(have.to(torch.uint8), -1)
            zq = zmin[..., None] + (first.float() + 0.5) * (span[..., None]
                                                             / LEVELS)
            out.append(torch.where(have.any(-1), zq, DMAX).reshape(-1, hw))
        return torch.cat(out)

    counted = bench(f"zbuf: count-matmul ({LEVELS} levels)", zbuf_counts,
                    vi, ui, z, ok)

    def zbuf_kernel(vi, ui, z, ok):
        return zbuf_scatter.zbuf_scatter_min(vi * cam + ui,
                                             torch.where(ok, z, DMAX), cam,
                                             cam, DMAX)

    form = ("hand kernel (zbuf_scatter_min.cu)" if device.type == "cuda"
            else "hand kernel's plain version")
    got = bench(f"zbuf: {form}", zbuf_kernel, vi, ui, z, ok).reshape(n, hw)
    kernel_err = float((got - ref).abs().max()) if n * hw else 0.0
    kernel_exact = bool(torch.equal(got, ref))
    print(f"  kernel exactness vs scatter: max|diff|={kernel_err:.2e}, "
          f"bit-equal {kernel_exact}", flush=True)
    errs = (counted - ref).abs().cpu().numpy()
    print(f"  count-matmul err: mean={errs.mean():.3f} "
          f"p99={np.percentile(errs, 99):.3f}", flush=True)

    # ---------------- hits scatter (G^3) ----------------
    cell = t(rng.randint(0, G, (n, q, 3)), torch.int32)

    def hits_library(cell, ok):
        flat = ((cell[..., 0] * G + cell[..., 1]) * G + cell[..., 2]).long()
        out = torch.zeros(n, G ** 3, device=device)
        return out.scatter_reduce_(1, flat, ok.float(), reduce="amax")

    ref_h = bench("hits: library scatter-max (scatter_reduce_)", hits_library,
                  cell, ok)
    xs = torch.arange(G, device=device)
    yzs = torch.arange(G * G, device=device)

    def hits_matmul(cell, ok):
        out = []
        for s in _chunks(n, 32):
            c, o = cell[s], ok[s]
            ohx = (c[..., 0][:, None, :] == xs[None, :, None]) & o[:, None, :]
            ohyz = (c[..., 1] * G + c[..., 2])[:, :, None] == yzs
            m = torch.bmm(ohx.to(torch.bfloat16), ohyz.to(torch.bfloat16))
            out.append((m > 0.5).float().reshape(-1, G ** 3))
        return torch.cat(out)

    out_h = bench("hits: one-hot matmul", hits_matmul, cell, ok)
    hits_exact = bool(torch.equal(out_h, ref_h))
    print(f"  hits exactness: {hits_exact}", flush=True)

    # ---------------- carve depth gather ----------------
    g3 = G ** 3
    depth = t(rng.uniform(1, 50, (n, cam, cam)), torch.float32)
    gvi = t(rng.randint(0, cam, (n, g3)), torch.int32)
    gui = t(rng.randint(0, cam, (n, g3)), torch.int32)

    def carve_library(depth, gvi, gui):
        return torch.gather(depth.reshape(n, hw), 1, (gvi * cam + gui).long())

    ref_c = bench("carve: library gather", carve_library, depth, gvi, gui)

    def carve_matmul(depth, gvi, gui):
        out = []
        for s in _chunks(n, 32):
            ohv = gvi[s][..., None] == rows
            tmp = torch.bmm(ohv.to(torch.bfloat16),
                            depth[s].to(torch.bfloat16)).float()   # [b, g3, cam]
            ohu = gui[s][..., None] == rows
            out.append((tmp * ohu).sum(-1))
        return torch.cat(out)

    out_c = bench("carve: one-hot matmul gather", carve_matmul, depth, gvi, gui)
    carve_err = float((out_c - ref_c).abs().max()) if n * g3 else 0.0
    print(f"  carve err (bf16 depth): max={carve_err:.4f}", flush=True)

    # ---------------- per-point zbuf gather (splat visibility) ----------------
    zbuf = t(rng.uniform(1, 50, (n, hw)), torch.float32)
    flat_q = t(rng.randint(0, hw, (n, q)), torch.int32)

    def vis_library(zbuf, flat):
        return torch.gather(zbuf, 1, flat.long())

    ref_v = bench("vis: library gather zbuf[flat_q]", vis_library, zbuf, flat_q)
    off = torch.arange(n, device=device)[:, None] * hw

    def vis_take(zbuf, flat):
        return torch.take(zbuf, (flat + off).long()).reshape(n, q)

    out_v = bench("vis: flat take", vis_take, zbuf, flat_q)
    vis_exact = bool(torch.equal(out_v, ref_v))
    print(f"  vis exactness: {vis_exact}", flush=True)
    return {"device": str(device), "ms": ms, "kernel_max_abs_err": kernel_err,
            "kernel_bit_equal": kernel_exact,
            "count_matmul_mean_err": float(errs.mean()),
            "hits_exact": hits_exact, "carve_max_err": carve_err,
            "vis_exact": vis_exact}


if __name__ == "__main__":
    main()
