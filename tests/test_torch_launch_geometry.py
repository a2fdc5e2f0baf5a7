"""The launch geometry of the port's kernels, computed on the CPU: how
many CTAs share one env, and what each holds in shared memory.  The fused
splat (``ops/fused_splat.py``) cuts the env's image into bands of rows,
one a CTA of a thread-block cluster; the hit scatter (``ops/scatter.py``)
holds the env's whole G^3 grid of flags in one CTA; the image gather
(``ops/gather.py``) runs a 1-D grid of threads that take vectors of 4
queries where the layout allows, and single queries where it does not;
the exact scatter-min z-buffer (``ops/zbuf_scatter.py``) cuts the env's
image into bands of rows with no halo between them, walked by persistent
CTAs, each half of a CTA building a band in a buffer of its own."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

from gennbv_tpu_torch.ops import _cuda, fused_splat, gather, scatter, zbuf_scatter

# (H, W, footprint): the eval's and the rollout's images, and the shapes of
# the card tests in tests/test_torch_card.py
SPLAT_SHAPES = [(400, 400, 1), (128, 128, 1), (16, 16, 1), (64, 48, 1),
                (40, 40, 0), (37, 53, 2), (401, 300, 1), (401, 300, 2)]


def _bands(h, ctas):
    band = fused_splat.band_rows(h, ctas)
    return [range(r * band, min(h, (r + 1) * band)) for r in range(ctas)]


@pytest.mark.parametrize("h,w,footprint", SPLAT_SHAPES)
def test_splat_bands_cover_the_image_and_fit(h, w, footprint):
    ctas = fused_splat.cluster_ctas(h, w, footprint)
    assert 1 <= ctas <= _cuda.MAX_CLUSTER == 8
    bands = _bands(h, ctas)
    rows = [r for b in bands for r in b]
    assert rows == list(range(h)), "every row in exactly one band, in order"
    assert all(len(b) >= footprint for b in bands)
    assert fused_splat.cta_smem_bytes(h, w, ctas) <= _cuda.SHARED_PER_CTA == 232_448


def test_splat_cluster_sizes_at_the_paths_shapes():
    """400x400: 8 CTAs of 50 rows, 100 KB of shared memory each, so two
    share an SM; 128x128: one CTA an env, also two to an SM."""
    assert fused_splat.cluster_ctas(400, 400, 1) == 8
    assert fused_splat.band_rows(400, 8) == 50
    assert fused_splat.cta_smem_bytes(400, 400, 8) <= _cuda.SHARED_TWO_PER_SM
    assert fused_splat.cluster_ctas(400, 400, 1) > 7 and \
        fused_splat.cta_smem_bytes(400, 400, 7) > _cuda.SHARED_TWO_PER_SM
    assert fused_splat.cluster_ctas(128, 128, 1) == 1
    assert fused_splat.cta_smem_bytes(128, 128, 1) <= _cuda.SHARED_TWO_PER_SM
    # 401 rows are not a multiple of the cluster size: the last band is short
    ctas = fused_splat.cluster_ctas(401, 300, 1)
    assert 401 % ctas and len(_bands(401, ctas)[-1]) < fused_splat.band_rows(401, ctas)


def test_splat_geometry_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError):
        fused_splat.cluster_ctas(1000, 1000, 1)
    # more CTAs would give bands thinner than the footprint
    with pytest.raises(ValueError):
        fused_splat.cluster_ctas(12, 20000, 3)


@pytest.mark.parametrize("g", [4, 20])
def test_scatter_flags_hold_the_grid_and_fit(g):
    """One byte a cell, in a multiple of 16 bytes for 16-byte stores, in
    one CTA's shared memory: 64 B at G = 4, 8,000 B at G = 20."""
    nbytes = scatter.flag_bytes(g)
    assert nbytes % 16 == 0 and g ** 3 <= nbytes < g ** 3 + 16
    assert nbytes <= _cuda.SHARED_PER_CTA == 232_448
    assert scatter.flag_bytes(20) == 8000


def test_scatter_geometry_refuses_what_no_cta_holds():
    assert scatter.flag_bytes(61) == 226_992
    with pytest.raises(ValueError):
        scatter.flag_bytes(62)


# (envs, queries an env): the eval's and the rollout's carve gathers
GATHER_SHAPES = [(50, 8000), (256, 8000)]


def _covers(geo, n, q):
    """The grid holds every query once: enough CTAs, and not one too many."""
    per_cta = gather.THREADS * gather.PER_THREAD
    return geo.ctas * per_cta >= n * q > (geo.ctas - 1) * per_cta


@pytest.mark.parametrize("n,q", GATHER_SHAPES)
def test_gather_geometry_at_the_paths_shapes(n, q):
    """Both paths' shapes take the vector path: one 16-byte vector of 4
    queries a thread, CTAs of 256 threads, no CTA tied to an env."""
    geo = gather.launch_geometry(n, q, 0, 1 << 20)
    assert (gather.PER_THREAD, gather.THREADS) == (4, 256)
    assert geo == gather.Geometry("vector", 4, -(-n * q // 1024))
    assert _covers(geo, n, q)


@pytest.mark.parametrize("n", [50, 256])
@pytest.mark.parametrize("q", [1, 3, 4, 8000, 8001, 11264])
def test_gather_path_follows_q(n, q):
    """A q that is not a multiple of the vector width takes the scalar
    path, single queries, so that no vector straddles two envs."""
    geo = gather.launch_geometry(n, q, 1 << 12, 1 << 13)
    assert geo.path == ("vector" if q % 4 == 0 else "scalar")
    assert geo.width == (4 if geo.path == "vector" else 1)
    assert _covers(geo, n, q)


@pytest.mark.parametrize("q", [8000, 11264, 4])
def test_gather_offset_view_takes_the_scalar_path(q):
    """A contiguous view one int32 into its buffer (``buf[1:]``) is not
    16-byte aligned: the wrapper's own inputs decide, from data_ptr()."""
    n = 3
    buf = torch.zeros(n * q + 1, dtype=torch.int32)
    vi, ui = buf[1:].view(n, q), buf[: n * q].view(n, q)
    assert vi.is_contiguous() and vi.data_ptr() % 16 == ui.data_ptr() % 16 + 4
    assert ui.data_ptr() % 16 == 0        # the allocator's alignment
    geo = gather.launch_geometry(n, q, vi.data_ptr(), ui.data_ptr())
    assert geo.path == "scalar" and geo.width == 1 and _covers(geo, n, q)
    assert gather.launch_geometry(n, q, ui.data_ptr(), ui.data_ptr()).path == "vector"


@pytest.mark.parametrize("vi_offset,ui_offset,path", [
    (0, 0, "vector"), (16, 48, "vector"), (256, 1024, "vector"),
    (4, 0, "scalar"), (0, 8, "scalar"), (12, 12, "scalar"), (0, 2, "scalar")])
def test_gather_vectors_need_alignment(vi_offset, ui_offset, path):
    """A vector of 4 queries is read with 16-byte loads, so both index
    arrays must start 16-byte aligned."""
    geo = gather.launch_geometry(2, 64, 1024 + vi_offset, 2048 + ui_offset)
    assert geo.path == path
    assert geo.width == (4 if path == "vector" else 1)
    assert _covers(geo, 2, 64)


@pytest.mark.parametrize("n,q,fits", [
    (1, 2 ** 31 - 4, True), (2 ** 15, 2 ** 16 - 1, True), (2 ** 16, 2 ** 15, False),
    (1, 2 ** 31, False), (3, 2 ** 30, False)])
def test_gather_geometry_refuses_what_the_kernel_does_not_index(n, q, fits):
    """The kernel counts queries in 32 bits: n * q must stay below 2^31."""
    if fits:
        geo = gather.launch_geometry(n, q, 0, 0)
        assert geo.path == ("vector" if q % 4 == 0 else "scalar")
        assert _covers(geo, n, q)
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            gather.launch_geometry(n, q, 0, 0)


# (H, W): the eval's and the rollout's images, the card tests' odd sizes,
# and a single row and a single column
ZBUF_SHAPES = [(400, 400), (128, 128), (16, 16), (37, 53), (401, 300),
               (1, 1000), (3000, 1), (64, 48), (90, 20000)]
# (envs, points an env) at each shape: one env and one point, a few envs,
# the eval's and the rollout's (and an env count past two waves of 132),
# no point at all
ZBUF_LOADS = [(1, 1), (5, 700), (50, 9216), (265, 11264), (4, 0)]
# the SM counts of an H100 SXM and PCIe, and of a card with one SM
SM_COUNTS = [132, 114, 1]


def _zbuf_items(n, h, w, geo):
    """Every item the kernel's CTAs walk (a CTA's two halves are its
    lanes; lane l of CTA c takes c + l * ctas, then every 2 * ctas on):
    its CTA, env, first pixel and pixel count, in the order of the walk."""
    items = n * geo.bands
    walk = [(c, np.arange(c + lane * geo.ctas, items, 2 * geo.ctas))
            for c in range(geo.ctas) for lane in range(2)]
    cta = np.concatenate([np.full(len(w_), c) for c, w_ in walk])
    walk = np.concatenate([w_ for _, w_ in walk])
    lo = walk % geo.bands * geo.rows * w
    return (walk, cta, walk // geo.bands, lo,
            np.minimum(geo.rows * w, h * w - lo))


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("h,w", ZBUF_SHAPES)
def test_zbuf_scatter_bands_cover_the_image_and_fit(h, w, sms):
    """The CTAs' walk, by two lanes a CTA, takes every item once, and each
    CTA the items c, c + ctas, c + 2 * ctas, ...; each env's bands hold
    every pixel exactly once, in order, the last no taller than the rest;
    a CTA's two band buffers (4 B a key) fit one CTA's shared memory; at
    most one CTA an SM."""
    for n, q in ZBUF_LOADS:
        geo = zbuf_scatter.geometry(n, q, h, w, sms)
        assert geo.ctas == min(n * geo.bands, sms)
        walk, cta, env, lo, count = _zbuf_items(n, h, w, geo)
        assert np.array_equal(np.sort(walk), np.arange(n * geo.bands))
        assert np.array_equal(cta[np.argsort(walk)],
                              np.arange(n * geo.bands) % geo.ctas)
        assert (count > 0).all()
        # each env's bands, in pixel order, tile [0, H*W) end to end
        order = np.lexsort((lo, env))
        env, lo, end = env[order], lo[order], (lo + count)[order]
        starts = np.r_[True, env[1:] != env[:-1]]
        ends = np.r_[env[1:] != env[:-1], True]
        assert np.array_equal(env[starts], np.arange(n))
        assert (lo[starts] == 0).all() and (end[ends] == h * w).all()
        assert np.array_equal(lo[~starts], end[:-1][~starts[1:]])
        assert (geo.bands - 1) * geo.rows < h <= geo.bands * geo.rows
        assert zbuf_scatter.BYTES_PER_PIXEL == 4 and zbuf_scatter.BUFFERS == 2
        assert zbuf_scatter.buffer_bytes(geo.rows, w) == 4 * geo.rows * w
        assert 2 * zbuf_scatter.buffer_bytes(geo.rows, w) <= \
            _cuda.SHARED_PER_CTA == 232_448
        assert zbuf_scatter.fits(geo.rows, w)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("h,w", ZBUF_SHAPES)
def test_zbuf_scatter_band_count_minimises_the_busiest_sm(h, w, sms):
    """Over every band height whose two buffers fit one CTA, none gives
    an SM less to move than the chosen one: the busiest SM's items
    (ceil(items / SMs)) times each item's cost (its band's bytes written,
    weighed 6 to 1, and its env's indices and depths read); among equals,
    the fewest bands.  The weight is the card's, fitted to a sweep of
    band heights (test_zbuf_scatter_geometry_at_the_paths_shapes holds
    what that sweep found fastest)."""
    for n, q in ZBUF_LOADS:
        geo = zbuf_scatter.geometry(n, q, h, w, sms)

        def busiest(rows):
            items = n * -(-h // rows)
            return -(-items // sms) * (6 * 4 * rows * w + 8 * q)

        best = busiest(geo.rows)
        for rows in range(1, h + 1):
            if 2 * zbuf_scatter.buffer_bytes(rows, w) > _cuda.SHARED_PER_CTA:
                continue
            assert busiest(rows) >= best
            if busiest(rows) == best:
                assert -(-h // rows) >= geo.bands


def test_zbuf_scatter_geometry_at_the_paths_shapes():
    """On 132 SMs, the fastest of a sweep of band heights on an H100 at
    both shapes.  The rollout (256 envs, Q 11,264, 128x128): one band an
    env, 256 items on 132 CTAs, at most 2 a CTA (one a lane); 2 to 7
    bands measured slower.  The eval (50 envs, Q 9,216, 400x400): 10
    bands of 40 rows, 500 items on 132 CTAs, at most 4 a CTA, 64,000 B a
    band; 7 bands of 58 rows (3 items of 92,800 B a CTA) came second, 6,
    8, 13, 15 and 20 bands slower.  On 114 SMs the eval takes 9 bands of
    45."""
    roll = zbuf_scatter.geometry(256, 11264, 128, 128, 132)
    assert roll == zbuf_scatter.Geometry(rows=128, bands=1, ctas=132)
    assert -(-256 // 132) == 2
    ev = zbuf_scatter.geometry(50, 9216, 400, 400, 132)
    assert ev == zbuf_scatter.Geometry(rows=40, bands=10, ctas=132)
    assert -(-500 // 132) == 4 and 4 * 40 * 400 == 64_000
    assert zbuf_scatter.fits(58, 400) and zbuf_scatter.fits(72, 400)
    assert not zbuf_scatter.fits(73, 400)
    item = 8 * 9216                       # an item's indices and depths
    assert 4 * (6 * 64_000 + item) < 3 * (6 * 92_800 + item)
    assert zbuf_scatter.geometry(50, 9216, 400, 400, 114) == \
        zbuf_scatter.Geometry(rows=45, bands=9, ctas=114)


def test_zbuf_scatter_geometry_refuses_what_no_cta_holds():
    """Two buffers of a row of more than 29,056 pixels (4 B a key) do not
    fit in one CTA; a row of 29,056 does, alone in its band; no envs or no
    SMs is no geometry."""
    assert zbuf_scatter.geometry(1, 10, 5, 20_000, 132).rows == 1
    assert zbuf_scatter.geometry(1, 10, 5, 29_056, 132).rows == 1
    assert 2 * 4 * 29_056 == _cuda.SHARED_PER_CTA
    with pytest.raises(ValueError):
        zbuf_scatter.geometry(1, 10, 5, 29_057, 132)
    with pytest.raises(ValueError):
        zbuf_scatter.geometry(0, 10, 5, 5, 132)
    with pytest.raises(ValueError):
        zbuf_scatter.geometry(1, 10, 5, 5, 0)
