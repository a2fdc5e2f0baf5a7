"""The launch geometry of the port's kernels, computed on the CPU: how
many CTAs share one env, and what each holds in shared memory.  The fused
splat (``ops/fused_splat.py``) cuts the env's image into bands of rows,
one a CTA of a thread-block cluster; the hit scatter (``ops/scatter.py``)
holds the env's whole G^3 grid of flags in one CTA; the image gather
(``ops/gather.py``) runs a 1-D grid of threads that take vectors of 4
queries where the layout allows, and single queries where it does not."""
import pytest
import torch

from gennbv_tpu_torch.ops import _cuda, fused_splat, gather, scatter

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
