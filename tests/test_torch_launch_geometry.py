"""The launch geometry of the port's splat and scatter kernels, computed
on the CPU: how many CTAs share one env, and what each holds in shared
memory.  The fused splat (``ops/fused_splat.py``) cuts the env's image
into bands of rows, one a CTA of a thread-block cluster; the hit scatter
(``ops/scatter.py``) holds the env's whole G^3 grid of flags in one CTA."""
import pytest

from gennbv_tpu_torch.ops import _cuda, fused_splat, scatter

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
